"""Build the native components on demand.

The native libraries (the shared-memory object store and the compiled
DAG's mutable channels: host libraries, not kernels) are compiled with
g++ once per source change into ``ray_tpu_torch/_build/native/`` and
loaded via ctypes (the C ABI + ctypes keeps the binding
dependency-free).
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
    "mutable_channel": ["mutable_channel.cpp"],
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


# Standalone sanitizer harnesses: a main() program compiled WITH the
# component's sources under -fsanitize and run as a subprocess by the
# tests (tests/test_torch_dag_channels.py runs the channel's under
# ASan+UBSan).
_SELFTESTS = {
    "mutable_channel_selftest": ["mutable_channel_selftest.cpp",
                                 "mutable_channel.cpp"],
}


def build_selftest(name: str) -> str:
    """Compile (if stale) an ASan+UBSan selftest binary; returns its path."""
    srcs = [os.path.join(_HERE, s) for s in _SELFTESTS[name]]
    out = os.path.join(_BUILD_DIR, f"{name}.asan_ubsan")
    return _compile(srcs, out,
                    ["-O1", "-g", "-fsanitize=address,undefined",
                     "-fno-omit-frame-pointer"])
