"""Deterministic segment sums: CUDA kernel + plain twin.

The local BA assembles its normal equations from per-edge blocks summed
by camera, by point and by (point, camera) pair: airdos_tpu's
``jnp.zeros(...).at[key].add(vals)`` (solvers/local_ba.py:119-142).  A
float ``index_add_`` on CUDA sums with atomics in a run-dependent order,
which would make offline runs differ byte for byte, so here:

- ``make_segments(key, n, keep)`` sorts the rows by key once (stable)
  and stores the CSR offsets of the n segments; rows outside ``keep``
  (the BA's padding and invalid edges, whose blocks are exact zeros) are
  keyed past the last segment and summed nowhere, so no segment holds a
  long run of them;
- ``segment_sum(vals, seg)`` on a CUDA tensor launches the sm_90a kernel
  of ``csrc/segment_sum.cu`` (built with nvcc at first use into
  ``airdos_tpu_torch/_build/``, bound through ctypes) or raises, and
  counts the launch; on a CPU tensor it runs ``segment_sum_ref``, the
  plain ``index_add_``, which sums each segment in row order as the
  kernel does.

The kernel design and what bounds it are described at the top of the
CUDA source.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from airdos_tpu_torch.ops import cuda_build

_SOURCE = cuda_build.CSRC / "segment_sum.cu"
_SIGNATURES = {
    "airdos_segment_sum": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p],
}

_launches = 0


def launches() -> int:
    """Kernel launches since the last reset_launches()."""
    return _launches


def reset_launches() -> None:
    global _launches
    _launches = 0


def build():
    """Compile csrc/segment_sum.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


class Segments(NamedTuple):
    key: torch.Tensor       # [E] int64 segment of each row (n: none)
    perm: torch.Tensor      # [E] int32 rows in stable key order
    offsets: torch.Tensor   # [n + 1] int32 CSR offsets into perm
    n: int                  # number of segments


def make_segments(key: torch.Tensor, n: int,
                  keep: Optional[torch.Tensor] = None) -> Segments:
    """The sorted-segment index of `key` (values in [0, n)); rows where
    the bool mask `keep` is False belong to no segment."""
    key = key.to(torch.int64)
    if keep is not None:
        key = torch.where(keep, key, torch.full_like(key, n))
    sorted_key, perm = torch.sort(key, stable=True)
    bounds = torch.arange(n + 1, dtype=torch.int64, device=key.device)
    offsets = torch.searchsorted(sorted_key, bounds)
    return Segments(key=key, perm=perm.to(torch.int32),
                    offsets=offsets.to(torch.int32), n=n)


def segment_sum_ref(vals: torch.Tensor, key: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Plain torch version: out[s] = sum of vals[e] with key[e] == s, for
    s in [0, n) (rows keyed n are dropped).  vals [E, K] float32 -> [n, K]."""
    out = torch.zeros((n + 1, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, key, vals)[:n]


def segment_sum_cuda(vals: torch.Tensor, seg: Segments) -> torch.Tensor:
    """Launch the sm_90a kernel on the current stream."""
    global _launches
    if not vals.is_cuda or vals.dtype != torch.float32 or vals.dim() != 2:
        raise ValueError("vals must be a CUDA float32 [rows, k] tensor, got "
                         f"{vals.dtype} {tuple(vals.shape)} on {vals.device}")
    for name, x in (("perm", seg.perm), ("offsets", seg.offsets)):
        if x.device != vals.device or x.dtype != torch.int32 or x.dim() != 1:
            raise ValueError(f"{name} must be an int32 vector on "
                             f"{vals.device}, got {x.dtype} on {x.device}")
    if seg.perm.shape[0] != vals.shape[0] or seg.offsets.shape[0] != seg.n + 1:
        raise ValueError(f"segments of {seg.perm.shape[0]} rows / "
                         f"{seg.offsets.shape[0] - 1} segments for "
                         f"{vals.shape[0]} rows / {seg.n} segments")
    k = vals.shape[1]
    if seg.n * k >= 2 ** 31 or vals.shape[0] * k >= 2 ** 31:
        raise ValueError(f"{seg.n} segments x {k} exceeds the kernel's grid")
    vals = vals.contiguous()
    out = torch.empty((seg.n, k), dtype=torch.float32, device=vals.device)
    fn = cuda_build.library(_SOURCE, _SIGNATURES).airdos_segment_sum
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = fn(vals.data_ptr(), seg.perm.contiguous().data_ptr(),
                 seg.offsets.contiguous().data_ptr(), out.data_ptr(), seg.n, k,
                 stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: cudaError {err}")
    _launches += 1
    return out


def segment_sum(vals: torch.Tensor, seg: Segments) -> torch.Tensor:
    """Segment sums of the rows of vals [E, K] float32 -> [seg.n, K].
    CUDA tensors go to the kernel; CPU tensors to the plain version."""
    if vals.is_cuda:
        return segment_sum_cuda(vals, seg)
    return segment_sum_ref(vals, seg.key, seg.n)
