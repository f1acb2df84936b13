"""The LM cost of one edge family in a fixed order: CUDA kernel + plain
twin.

airdos_tpu's local and human BAs decide each Levenberg-Marquardt step by
the cost sum(where(isfinite(rho), rho, 1e30) * active) of every edge
family (solvers/local_ba.py:176-182, solvers/human_ba.py:223-243), summed
in XLA's order.  Here the order is fixed, so the kernel and its plain
version agree bit for bit and a sum on the card is the same from run to
run:

- 1024 partial sums: partial j adds the terms j, j + 1024, j + 2048, ...
  in sequence, from 0;
- a halving tree over the partials: j + 512, then 256, ..., 1.

``lm_cost(rho, active)`` on CUDA tensors launches the sm_90a kernel of
``csrc/lm_cost.cu`` (one block of 1024 threads) on the calling thread's
current stream (built with nvcc at first use into
``airdos_tpu_torch/_build/``, bound through ctypes) or raises, and counts
the launch, by thread and stream priority too; on CPU tensors it runs
``lm_cost_ref``, which pads the terms with zeros to a multiple of 1024,
adds the [n / 1024, 1024] rows in sequence and halves ten times.  On a
mesh each rank's sum is psum-added where airdos_tpu psums.
"""
from __future__ import annotations

import ctypes

import torch

from airdos_tpu_torch.ops import cuda_build
from airdos_tpu_torch.ops.cuda_build import check_tensor

PARTIALS = 1024                  # the kernel's threads, one partial each
NON_FINITE = 1e30                # the cost of a non-finite edge


def lm_cost_ref(rho: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the 0-dim float32 sum of
    where(isfinite(rho), rho, 1e30) * active in the fixed order."""
    v = torch.where(torch.isfinite(rho), rho,
                    torch.full_like(rho, NON_FINITE)) * active
    m = -(-v.shape[0] // PARTIALS)
    v = torch.cat([v, v.new_zeros(m * PARTIALS - v.shape[0])])
    rows = v.reshape(m, PARTIALS)
    acc = v.new_zeros(PARTIALS)
    for i in range(m):
        acc = acc + rows[i]
    half = PARTIALS // 2
    while half:
        acc = acc[:half] + acc[half:2 * half]
        half //= 2
    return acc[0]


_SOURCE = cuda_build.CSRC / "lm_cost.cu"
_SIGNATURES = {
    "airdos_lm_cost": [ctypes.c_void_p] * 2 + [ctypes.c_int]
    + [ctypes.c_void_p] * 2,
}
_kernel = None                   # the bound C entry point, once loaded

_counter = cuda_build.LaunchCounter()


def launches() -> int:
    """Kernel launches since the last reset_launches()."""
    return _counter.total


def launch_tally() -> dict:
    """{("lm_cost", thread name, stream priority): launches} since the last
    reset_launches()."""
    return {("lm_cost",) + key: n for key, n in _counter.tally().items()}


def reset_launches() -> None:
    _counter.reset()


def build():
    """Compile csrc/lm_cost.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def lm_cost_cuda(rho: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Launch the sm_90a kernel on the current stream: lm_cost_ref's sum."""
    global _kernel
    dev = rho.device
    if not rho.is_cuda:
        raise ValueError(f"rho must be a CUDA tensor, got {dev}")
    n = rho.shape[0] if rho.dim() == 1 else -1
    check_tensor("rho", rho, torch.float32, (n,), dev)
    check_tensor("active", active, torch.float32, (n,), dev)
    if _kernel is None:
        _kernel = cuda_build.library(_SOURCE, _SIGNATURES).airdos_lm_cost
    out = torch.empty((), dtype=torch.float32, device=dev)
    with cuda_build.on_device(dev):
        err = _kernel(rho.data_ptr(), active.data_ptr(), n, out.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lm_cost kernel launch failed: cudaError {err}")
    _counter.count(cuda_build.stream_priority(dev))
    return out


def lm_cost(rho: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """The family's cost, a 0-dim float32 tensor, of its robust costs rho
    [n] and activity active [n] float32.  CUDA tensors go to the kernel,
    CPU tensors to the plain version."""
    if rho.is_cuda:
        return lm_cost_cuda(rho, active)
    return lm_cost_ref(rho, active)
