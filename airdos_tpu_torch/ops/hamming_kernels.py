"""All-pairs Hamming matrix of 256-bit descriptors: CUDA kernel + plain twin.

The counterpart of airdos_tpu/ops/pallas_kernels.py.  No path of the
port calls the kernel: every matcher's gated distances (the tracking
matchers, the loop's Sim3 match, fusion and triangulation, the last two
where airdos_tpu reaches the Pallas kernel under jax.vmap) are
ops/match_kernels.match_rows, which forms no matrix and whose plain
version calls ``hamming_matrix_ref`` / ``hamming_matrix_batched_ref``.
``hamming_matrix`` and ``hamming_matrix_batched`` stay the Pallas
kernel's port, held to their plain versions on the card.  Both:

- on a CUDA tensor launch the sm_90a kernel of ``csrc/hamming.cu``
  on the calling thread's current stream (built with nvcc at first use
  into ``airdos_tpu_torch/_build/``, bound through ctypes) or raise, and
  count the launch, by thread and stream priority too;
- on a CPU tensor run the plain torch version (``hamming_matrix_ref``,
  ``hamming_matrix_batched_ref``).

``hamming_matrix_and_popc`` repeats the kernel's arithmetic (popc(a) +
popc(b) - 2 popc(a & b), the AND-popcount of a binary tensor-core MMA) in
plain torch, so that the CPU tests hold it to the XOR form.

Descriptors are [N, 8] int32 tensors holding the bit patterns of the
uint32 words (see ops/brief.pack_u32).  The kernel design and what bounds
it are described at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from airdos_tpu_torch.ops import cuda_build

_SOURCE = cuda_build.CSRC / "hamming.cu"
_SIGNATURES = {
    "airdos_hamming_matrix_batched": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p],
}
_MAX_ROW_BLOCKS = 65535          # gridDim.y limit; 64 rows per block
_MAX_BATCH = 65535               # gridDim.z limit
_kernel = None                   # the bound C entry point, once loaded

_counter = cuda_build.LaunchCounter()           # 2-D launches
_batched_counter = cuda_build.LaunchCounter()   # batched launches


def launches() -> int:
    """2-D kernel launches since the last reset_launches()."""
    return _counter.total


def batched_launches() -> int:
    """Batched kernel launches since the last reset_launches()."""
    return _batched_counter.total


def launch_tally() -> dict:
    """{(kernel, thread name, stream priority): launches} since the last
    reset_launches(), kernel "hamming_matrix" or
    "hamming_matrix_batched"."""
    return {(name,) + key: n
            for name, counter in (("hamming_matrix", _counter),
                                  ("hamming_matrix_batched",
                                   _batched_counter))
            for key, n in counter.tally().items()}


def reset_launches() -> None:
    _counter.reset()
    _batched_counter.reset()


def build():
    """Compile csrc/hamming.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


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


def hamming_matrix_and_popc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain torch: popc(a) + popc(b) -
    2 popc(a & b) per pair, the AND-popcount summed over the 8 words as
    one binary MMA sums its k = 256 bits.  Equal to hamming_matrix_ref.
    a [N, 8], b [M, 8] int32 -> int32 [N, M]."""
    a64 = a.to(torch.int64) & 0xFFFFFFFF
    b64 = b.to(torch.int64) & 0xFFFFFFFF
    both = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int64,
                       device=a.device)
    for k in range(a.shape[1]):
        both += _popcount32(a64[:, None, k] & b64[None, :, k])
    pa = _popcount32(a64).sum(1)
    pb = _popcount32(b64).sum(1)
    return (pa[:, None] + pb[None, :] - 2 * both).to(torch.int32)


def hamming_matrix_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the sm_90a kernel on the current stream.  a [N, 8], b [M, 8]
    int32 CUDA tensors -> int32 [N, M]."""
    _check(a, b, 2)
    out = _launch(a[None], b[None])[0]
    _counter.count(cuda_build.stream_priority(a.device))
    return out


def _check(a: torch.Tensor, b: torch.Tensor, dim: int) -> None:
    shape = "[n, 8]" if dim == 2 else "[batch or 1, n, 8]"
    for name, x in (("a", a), ("b", b)):
        if not x.is_cuda or x.dtype != torch.int32 or x.dim() != dim \
                or x.shape[-1] != 8:
            raise ValueError(f"{name} must be a CUDA int32 {shape} tensor, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    n, m = a.shape[-2], b.shape[-2]
    if -(-n // 64) > _MAX_ROW_BLOCKS or n * m >= 2 ** 62:
        raise ValueError(f"shape {n} x {m} exceeds the kernel's grid")


def hamming_matrix_batched_ref(a: torch.Tensor,
                               b: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the batched entry point: the 2-D plain
    version per batch row.  a [B or 1, N, 8], b [B or 1, M, 8] int32 ->
    int32 [B, N, M]."""
    B = max(a.shape[0], b.shape[0])
    return torch.stack([hamming_matrix_ref(a[i if a.shape[0] > 1 else 0],
                                           b[i if b.shape[0] > 1 else 0])
                        for i in range(B)])


def hamming_matrix_batched_cuda(a: torch.Tensor,
                                b: torch.Tensor) -> torch.Tensor:
    """One launch for the whole batch (gridDim.z = B); an operand with a
    batch dimension of 1 is shared (batch stride 0)."""
    _check(a, b, 3)
    B = max(a.shape[0], b.shape[0])
    for name, x in (("a", a), ("b", b)):
        if x.shape[0] not in (1, B):
            raise ValueError(f"{name} has batch {x.shape[0]}, want 1 or {B}")
    if B > _MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernel's grid")
    out = _launch(a, b)
    _batched_counter.count(cuda_build.stream_priority(a.device))
    return out


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous and starting on 16 bytes: the kernel reads each
    descriptor as two 16-byte vectors."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The one launch path of both wrappers (operands already checked):
    a [B or 1, n, 8], b [B or 1, m, 8] -> [B, n, m] on the current
    stream."""
    global _kernel
    if _kernel is None:
        _kernel = cuda_build.library(
            _SOURCE, _SIGNATURES).airdos_hamming_matrix_batched
    B = max(a.shape[0], b.shape[0])
    n, m = a.shape[1], b.shape[1]
    a, b = _aligned(a), _aligned(b)
    out = torch.empty((B, n, m), dtype=torch.int32, device=a.device)
    with cuda_build.on_device(a.device):
        err = _kernel(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, m, B,
                      n * 8 if a.shape[0] > 1 else 0,
                      m * 8 if b.shape[0] > 1 else 0,
                      torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hamming kernel launch failed: cudaError {err}")
    return out


def hamming_matrix_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched all-pairs Hamming distances (the vmapped Pallas kernel of
    airdos_tpu), a [B or 1, N, 8], b [B or 1, M, 8] int32 -> int32
    [B, N, M].  CUDA tensors go to the kernel; CPU tensors to the plain
    version."""
    if a.is_cuda or b.is_cuda:
        return hamming_matrix_batched_cuda(a, b)
    return hamming_matrix_batched_ref(a, b)


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distances, a [N, 8], b [M, 8] int32 -> int32
    [N, M].  CUDA tensors go to the kernel; CPU tensors to the plain
    version."""
    if a.is_cuda or b.is_cuda:
        return hamming_matrix_cuda(a, b)
    return hamming_matrix_ref(a, b)
