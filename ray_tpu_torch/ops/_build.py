"""Build the port's CUDA kernels from ``ops/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``ray_tpu_torch/_build/lib<name>-<hash>.so``,
where the hash covers the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source is rebuilt. ``build`` starts one ``nvcc``
per source, all together. The library is loaded with ``ctypes``; the
caller declares its functions' argument types. Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(*names: str) -> Dict[str, Tuple[Path, str]]:
    """Compile each ``csrc/<name>.cu`` that is not built already, one
    ``nvcc`` per source, all started together. Returns, for each name, the
    library's path and nvcc's output (its register, shared-memory and
    spill report; empty when nothing was compiled). Raises with that
    output when an nvcc fails."""
    out, procs = {}, {}
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = (target, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (target, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (target, tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)   # atomic: a reader never sees half a file
        out[name] = (target, log)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[name][0]))
            _loaded[name] = lib
        return lib
