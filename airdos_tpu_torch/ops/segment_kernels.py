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
- ``make_compact_segments(key, keep)`` does the same over the distinct
  values of a sparse key (the human BA's flat (row, col) positions in its
  dense normal equations, airdos_tpu/solvers/human_ba.py:296-342, where
  one position collects many edges' entries);
- ``segment_sum(vals, seg)`` on a CUDA tensor launches the sm_90a kernel
  of ``csrc/segment_sum.cu`` on the calling thread's current stream
  (built with nvcc at first use into ``airdos_tpu_torch/_build/``, bound
  through ctypes) or raises, and counts the launch, by thread and stream
  priority too; on a CPU tensor it runs ``segment_sum_ref``, the
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
                           ctypes.c_int, ctypes.c_void_p],
}
_kernel = None                   # the bound C entry point, once loaded

_counter = cuda_build.LaunchCounter()


def launches() -> int:
    """Kernel launches since the last reset_launches()."""
    return _counter.total


def launch_tally() -> dict:
    """{("segment_sum", thread name, stream priority): launches} since
    the last reset_launches()."""
    return {("segment_sum",) + key: n for key, n in _counter.tally().items()}


def reset_launches() -> None:
    _counter.reset()


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


def make_compact_segments(key: torch.Tensor, keep: torch.Tensor):
    """The sorted-segment index of the distinct kept values of `key` (any
    non-negative int64, e.g. flat positions in a dense matrix): segment s
    holds the kept rows whose key is the s-th smallest distinct kept key.
    Returns (Segments, the distinct keys [n] in increasing order).  Reads
    the number of distinct keys on the host, once."""
    key = key.to(torch.int64)
    uniq = torch.unique(key[keep])
    slot = torch.searchsorted(uniq, key)
    return make_segments(slot, uniq.shape[0], keep), uniq


def segment_sum_ref(vals: torch.Tensor, key: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Plain torch version: out[s] = sum of vals[e] with key[e] == s, for
    s in [0, n) (rows keyed n are dropped).  vals [E, K] float32 -> [n, K]."""
    out = torch.zeros((n + 1, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, key, vals)[:n]


def segment_sum_cuda(vals: torch.Tensor, seg: Segments) -> torch.Tensor:
    """Launch the sm_90a kernel on the current stream."""
    global _kernel
    if not vals.is_cuda or vals.dtype != torch.float32 or vals.dim() != 2:
        raise ValueError("vals must be a CUDA float32 [rows, k] tensor, got "
                         f"{vals.dtype} {tuple(vals.shape)} on {vals.device}")
    for name, x in (("perm", seg.perm), ("offsets", seg.offsets)):
        if x.device != vals.device or x.dtype != torch.int32 or x.dim() != 1:
            raise ValueError(f"{name} must be an int32 vector on "
                             f"{vals.device}, got {x.dtype} on {x.device}")
    rows, k = vals.shape
    if seg.perm.shape[0] != rows or seg.offsets.shape[0] != seg.n + 1:
        raise ValueError(f"segments of {seg.perm.shape[0]} rows / "
                         f"{seg.offsets.shape[0] - 1} segments for "
                         f"{rows} rows / {seg.n} segments")
    if seg.n * k >= 2 ** 31 or rows * k >= 2 ** 31:
        raise ValueError(f"{seg.n} segments x {k} exceeds the kernel's grid")
    if _kernel is None:
        _kernel = cuda_build.library(_SOURCE, _SIGNATURES).airdos_segment_sum
    vals = vals.contiguous()
    out = torch.empty((seg.n, k), dtype=torch.float32, device=vals.device)
    with cuda_build.on_device(vals.device):
        err = _kernel(vals.data_ptr(), seg.perm.contiguous().data_ptr(),
                      seg.offsets.contiguous().data_ptr(), out.data_ptr(),
                      rows, seg.n, k,
                      torch.cuda.current_stream(vals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: cudaError {err}")
    _counter.count(cuda_build.stream_priority(vals.device))
    return out


def segment_sum(vals: torch.Tensor, seg: Segments) -> torch.Tensor:
    """Segment sums of the rows of vals [E, K] float32 -> [seg.n, K].
    CUDA tensors go to the kernel; CPU tensors to the plain version."""
    if vals.is_cuda:
        return segment_sum_cuda(vals, seg)
    return segment_sum_ref(vals, seg.key, seg.n)
