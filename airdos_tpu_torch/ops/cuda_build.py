"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each kernel source has a plain C interface.  It is compiled with nvcc for
sm_90a at first use into the git-ignored ``airdos_tpu_torch/_build/``,
under a name keyed by the source's hash (an edited source is rebuilt), and
loaded with ctypes.  Nothing here runs at import time, so the kernel
modules import on machines without nvcc or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

_libs = {}
_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       f"from {CSRC} at first use on a CUDA machine")


def build(source: Path) -> Path:
    """Compile one .cu file for sm_90a into _build/ and return the
    library's path (reused while the source is unchanged)."""
    src = source.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:12]
    out = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def library(source: Path, signatures) -> ctypes.CDLL:
    """The loaded library of `source`, built if needed.  signatures maps
    each C entry point to its ctypes argument types; every entry point
    returns the cudaError_t of its launch as an int."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[source] = lib
    return lib
