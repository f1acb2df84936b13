"""All-pairs Hamming matrix of 256-bit descriptors: CUDA kernel + plain twin.

The counterpart of airdos_tpu/ops/pallas_kernels.py.  Every matcher of the
tracking path (stereo, motion-model projection, local-map projection)
calls ``hamming_matrix``:

- on a CUDA tensor it launches the sm_90a kernel of ``csrc/hamming.cu``
  (built with nvcc at first use into ``airdos_tpu_torch/_build/``, bound
  through ctypes) or raises;
- on a CPU tensor it runs ``hamming_matrix_ref``, the plain torch version.

Descriptors are [N, 8] int32 tensors holding the bit patterns of the
uint32 words (see ops/brief.pack_u32).  The kernel design and what bounds
it are described at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "hamming.cu"
_BUILD_DIR = _PKG / "_build"
_MAX_ROW_BLOCKS = 65535          # gridDim.y limit; 64 rows per block

_lib = None
_lib_lock = threading.Lock()
_launches = 0


def launches() -> int:
    """Kernel launches since the last reset_launches()."""
    return _launches


def reset_launches() -> None:
    global _launches
    _launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the Hamming kernel is built from "
                       f"{_SOURCE} at first use on a CUDA machine")


def build() -> Path:
    """Compile csrc/hamming.cu for sm_90a into _build/ (keyed by the
    source's hash, so an edited source is rebuilt) and return the path."""
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:12]
    out = _BUILD_DIR / f"libairdos_hamming_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           str(_SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.airdos_hamming_matrix
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of the low 32 bits of an int64 tensor."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def hamming_matrix_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch version: popcount of the broadcast XOR, word by word.
    a [N, 8], b [M, 8] int32 -> int32 [N, M]."""
    acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int64,
                      device=a.device)
    for k in range(a.shape[1]):
        x = (a[:, None, k] ^ b[None, :, k]).to(torch.int64) & 0xFFFFFFFF
        acc += _popcount32(x)
    return acc.to(torch.int32)


def hamming_matrix_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the sm_90a kernel on the current stream.  a [N, 8], b [M, 8]
    int32 CUDA tensors -> int32 [N, M]."""
    global _launches
    for name, x in (("a", a), ("b", b)):
        if not x.is_cuda or x.dtype != torch.int32 or x.dim() != 2 \
                or x.shape[1] != 8:
            raise ValueError(f"{name} must be a CUDA int32 [n, 8] tensor, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    n, m = a.shape[0], b.shape[0]
    if -(-n // 64) > _MAX_ROW_BLOCKS or n * m >= 2 ** 62:
        raise ValueError(f"shape {n} x {m} exceeds the kernel's grid")
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty((n, m), dtype=torch.int32, device=a.device)
    fn = _library().airdos_hamming_matrix
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, m, stream)
    if err != 0:
        raise RuntimeError(f"hamming kernel launch failed: cudaError {err}")
    _launches += 1
    return out


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distances, a [N, 8], b [M, 8] int32 -> int32
    [N, M].  CUDA tensors go to the kernel; CPU tensors to the plain
    version."""
    if a.is_cuda or b.is_cuda:
        return hamming_matrix_cuda(a, b)
    return hamming_matrix_ref(a, b)
