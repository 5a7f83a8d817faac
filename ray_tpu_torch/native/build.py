"""Build the native components on demand.

The native library (the shared-memory object store, a host library, not
a kernel) is compiled with g++ once per source change into
``ray_tpu_torch/_build/native/`` and loaded via ctypes (the C ABI +
ctypes keeps the binding dependency-free).
"""

from __future__ import annotations

import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build", "native")
_LOCK = threading.Lock()

_SOURCES = {
    "shm_store": ["shm_store.cpp"],
}


def lib_path(name: str) -> str:
    return os.path.join(_BUILD_DIR, f"lib{name}.so")


def _compile(srcs, out, flags) -> str:
    """Compile (if stale vs source mtimes) srcs -> out; atomic replace."""
    with _LOCK:
        src_mtime = max(os.path.getmtime(s) for s in srcs)
        if os.path.exists(out) and os.path.getmtime(out) >= src_mtime:
            return out
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp.{os.getpid()}"  # per-process tmp; os.replace is atomic
        cmd = ["g++", "-std=c++17", *flags, "-o", tmp, *srcs, "-lpthread"]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def build(name: str) -> str:
    """Compile (if stale) and return the path to lib<name>.so."""
    srcs = [os.path.join(_HERE, s) for s in _SOURCES[name]]
    return _compile(srcs, lib_path(name),
                    ["-O2", "-g", "-shared", "-fPIC"])
