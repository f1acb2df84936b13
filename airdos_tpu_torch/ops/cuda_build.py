"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each kernel source has a plain C interface.  It is compiled with nvcc for
sm_90a at first use into the git-ignored ``airdos_tpu_torch/_build/``,
under a name keyed by the hash of the source and of the headers of
``csrc/`` (an edited source or header is rebuilt), and loaded with
ctypes.  Nothing here runs at import time, so the kernel
modules import on machines without nvcc or a card.  ``LaunchCounter``
counts a wrapper's launches from every thread of online mode.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

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
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # what a source may include
        digest.update(header.read_bytes())
    tag = digest.hexdigest()[:12]
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


class LaunchCounter:
    """The launches of one kernel since the last reset: the total, and a
    tally by (the launching thread's name, the priority of its current
    stream), which shows which stream each thread's launches went to.
    Online mode launches from the tracking thread and the worker threads
    at once, so every update takes a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total = 0
        self._tally = collections.Counter()

    _names = threading.local()      # each thread's name, looked up once

    def count(self, priority: int) -> None:
        name = self._names.__dict__.get("name")
        if name is None:
            name = self._names.name = threading.current_thread().name
        key = (name, priority)
        with self._lock:
            self._total += 1
            self._tally[key] += 1

    @property
    def total(self) -> int:
        return self._total

    def tally(self) -> dict:
        """{(thread name, stream priority): launches}."""
        with self._lock:
            return dict(self._tally)

    def reset(self) -> None:
        with self._lock:
            self._total = 0
            self._tally.clear()


def stream_priority(device: torch.device) -> int:
    """The priority of the calling thread's current stream on `device`."""
    return torch.cuda.current_stream(device).priority


def check_tensor(name: str, x: torch.Tensor, dtype, shape, device):
    """Raise unless x is a contiguous `dtype` tensor of `shape` (None: any
    extent) on `device`: what a kernel's C entry point takes."""
    if x.device != device or x.dtype != dtype or not x.is_contiguous() \
            or x.dim() != len(shape) \
            or any(s is not None and s != n for s, n in zip(shape, x.shape)):
        want = "x".join("*" if s is None else str(s) for s in shape)
        raise ValueError(f"{name} must be a contiguous {dtype} [{want}] "
                         f"tensor on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def consts(*values) -> ctypes.Array:
    """Scalars as the float32 array a kernel's C entry point takes (and
    copies into a struct passed by value)."""
    return (ctypes.c_float * len(values))(
        *(float(np.float32(v)) for v in values))


# floats between the starts of two levels' views in a flat buffer: 128
# bytes, a cache line, so no line holds two levels and every view is
# 16-byte aligned
LEVEL_ALIGN = 32


def level_offsets(shapes):
    """The offset (in elements) of each [h, w] level in a flat buffer, each
    a multiple of LEVEL_ALIGN, and the buffer's length."""
    offsets, at = [], 0
    for h, w in shapes:
        offsets.append(at)
        at += -(-int(h) * int(w) // LEVEL_ALIGN) * LEVEL_ALIGN
    return offsets, at


def level_views(shapes, device, dtype=torch.float32):
    """Contiguous [h, w] views, one a shape, into one flat buffer (one
    allocation) at level_offsets: one as_strided call a view, not a slice
    and a view."""
    offsets, total = level_offsets(shapes)
    buf = torch.empty(total, dtype=dtype, device=device)
    return tuple(buf.as_strided((int(h), int(w)), (int(w), 1), o)
                 for o, (h, w) in zip(offsets, shapes))


def on_device(device: torch.device):
    """The context a launch on `device` needs: none when it is already the
    current CUDA device (the common case), else torch.cuda.device."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
