"""Keypoint selection of every pyramid level of one image: CUDA kernel +
plain twin.

Per level, the per-cell best corner of the level's detection map
(ops/fast.fast_nms: thresholded and non-max suppressed), with a boost for
corners above the high threshold, then a spatially fair top-quota: cells
ranked within 4x4-cell blocks, every block's best cell before any block's
second best (the shape-static form of the reference's DistributeOctTree,
ORBextractor.cc:452-644, as airdos_tpu/features/orb.py builds it).

The extractor (features/orb.py) calls ``select_keypoints`` once an image,
after the image's fast_nms calls:

- on CUDA tensors it launches the sm_90a kernel of ``csrc/select.cu`` (a
  thread block cluster of ``CLUSTER`` blocks a level) on the calling
  thread's current stream (built with nvcc
  at first use into ``airdos_tpu_torch/_build/``, bound through ctypes) or
  raises, and counts the launch, by thread and stream priority too;
- on CPU tensors it runs ``select_keypoints_ref``: ``select_level_ref``
  level by level.

Both return xs, ys [sum(quotas)] int64 and the response [sum(quotas)]
float32 (0 = an empty slot), level after level, bit-equal.  The kernel
design and what bounds it are described at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from airdos_tpu_torch.ops import cuda_build

INI_BOOST = 1000.0     # selection boost for corners passing the high threshold
BLOCK = 4              # cells a fairness block's edge
# the kernel's shared memory, a block's most (H100: 227 KB)
MAX_SMEM = 232448
# csrc/select.cu's launch: a cluster of CLUSTER blocks of THREADS threads a
# level; the leader block (rank 0) ranks and sorts the level's cells
CLUSTER = 8
THREADS = 512
WARPS = THREADS // 32
SORT_WORDS = 2         # sort words a thread holds, up to 1024 words


def _top_k_lower_index_first(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, ties broken toward the lower index
    (jax.lax.top_k's order; torch.topk documents none)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def select_level_ref(s: torch.Tensor, quota: int, cell: int, ini_th: float):
    """Per-cell best + spatially fair top-K of one level's detection map s.
    Returns xs, ys [quota] int64 and response [quota] float32 (0 response
    = invalid slot)."""
    h, w = s.shape
    dev = s.device
    sel = torch.where(s > ini_th, s + INI_BOOST, s)

    ncy, ncx = -(-h // cell), -(-w // cell)
    sp = F.pad(sel, (0, ncx * cell - w, 0, ncy * cell - h))
    cells = sp.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3) \
              .reshape(ncy, ncx, cell * cell)
    best_score, best_in_cell = torch.max(cells, dim=-1)
    cy = torch.arange(ncy, device=dev)[:, None]
    cx = torch.arange(ncx, device=dev)[None, :]
    ys_cell = cy * cell + best_in_cell // cell
    xs_cell = cx * cell + best_in_cell % cell

    # Spatially fair selection (the quadtree's guarantee, reference
    # ORBextractor::DistributeOctTree): rank cells by response within
    # 4x4-cell blocks, then take every block's best cell before any
    # block's second-best.
    nby, nbx = -(-ncy // BLOCK), -(-ncx // BLOCK)
    bs = F.pad(best_score, (0, nbx * BLOCK - ncx, 0, nby * BLOCK - ncy))
    blocks = bs.reshape(nby, BLOCK, nbx, BLOCK).permute(0, 2, 1, 3) \
               .reshape(nby * nbx, BLOCK * BLOCK)
    order = torch.sort(-blocks, dim=-1, stable=True).indices
    ranks = torch.empty_like(order).scatter_(
        1, order,
        torch.arange(BLOCK * BLOCK, device=dev).expand(order.shape).contiguous())
    ranks = torch.where(blocks > 0, ranks, torch.full_like(ranks, BLOCK * BLOCK))
    ranks = ranks.reshape(nby, nbx, BLOCK, BLOCK).permute(0, 2, 1, 3) \
                 .reshape(nby * BLOCK, nbx * BLOCK)[:ncy, :ncx]
    key = best_score - ranks.to(best_score.dtype) * (2.0 * INI_BOOST)

    flat_key = key.reshape(-1)
    k = min(quota, flat_key.shape[0])
    top_idx = _top_k_lower_index_first(flat_key, k)
    top_scores = best_score.reshape(-1)[top_idx]
    xs = xs_cell.reshape(-1)[top_idx]
    ys = ys_cell.reshape(-1)[top_idx]
    resp = torch.where(top_scores > 0, torch.remainder(top_scores, INI_BOOST),
                       torch.zeros_like(top_scores))
    if k < quota:
        pad = quota - k
        xs = F.pad(xs, (0, pad))
        ys = F.pad(ys, (0, pad))
        resp = F.pad(resp, (0, pad))
    return xs, ys, resp


def select_keypoints_ref(maps: Sequence[torch.Tensor], quotas: Sequence[int],
                         cells: Sequence[int], ini_th: float):
    """Plain torch version: select_level_ref of each level, concatenated."""
    out = [select_level_ref(s, q, c, ini_th)
           for s, q, c in zip(maps, quotas, cells)]
    return tuple(torch.cat(parts) for parts in zip(*out))


_SOURCE = cuda_build.CSRC / "select.cu"
_I32P = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "airdos_select": [ctypes.POINTER(ctypes.c_int64)] + [_I32P] * 5
    + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 3
    + [ctypes.c_int, ctypes.c_void_p],
}
_kernel = None                   # the bound C entry point, once loaded
MAX_LEVELS = 16                  # the kernel's Levels table

_counter = cuda_build.LaunchCounter()


def launches() -> int:
    """Kernel launches since the last reset_launches()."""
    return _counter.total


def launch_tally() -> dict:
    """{("select", thread name, stream priority): launches} since the last
    reset_launches()."""
    return {("select",) + key: n for key, n in _counter.tally().items()}


def reset_launches() -> None:
    _counter.reset()


def build():
    """Compile csrc/select.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def scan_cells(n_cells: int, rank: int, warp: int) -> range:
    """The cells that warp `warp` of cluster rank `rank` scans: the
    cluster's global warp rank * WARPS + warp takes every CLUSTER * WARPS-th
    cell (csrc/select.cu)."""
    return range(rank * WARPS + warp, n_cells, CLUSTER * WARPS)


def _words(n_cells: int) -> int:
    """The sort words of a level: its cells rounded up to a power of two."""
    p = 1
    while p < n_cells:
        p <<= 1
    return p


def sort_words(p: int) -> int:
    """The sort words a sorting thread of the leader holds for p words
    (csrc/select.cu sort_words): SORT_WORDS consecutive words on p /
    SORT_WORDS threads (at least a warp); 0 past SORT_WORDS * THREADS,
    where the network runs in shared memory alone."""
    if p <= 32:
        return 1
    if p <= SORT_WORDS * THREADS:
        return min(SORT_WORDS, p // 32)
    return 0


def sort_stages(n_cells: int):
    """The bitonic network's stages (k, j) over the cells rounded up to a
    power of two, in the kernel's order, each with where it runs: "shared"
    (shared memory, a block barrier after it; j >= 32 words), "shuffle"
    (between the lanes of a warp) or "thread" (between a thread's own
    words; j < words), for `words` = sort_words(p) a thread."""
    p = _words(n_cells)
    words = sort_words(p)
    stages = []
    k = 2
    while k <= p:
        j = k >> 1
        while j > 0:
            kind = "shared" if not words or j >= 32 * words else \
                "shuffle" if j >= words else "thread"
            stages.append((k, j, kind))
            j >>= 1
        k <<= 1
    return stages


def sort_barriers(n_cells: int) -> int:
    """The sort's block barriers: one once the words are written, one a
    shared-memory stage, and where threads hold words, one for each k
    whose stages start in shared memory (the words stored there first)
    and one before the slots read the sorted words."""
    stages = sort_stages(n_cells)
    shared = sum(kind == "shared" for _, _, kind in stages)
    if not sort_words(_words(n_cells)):
        return 1 + shared
    return 1 + shared \
        + len({k for k, j, kind in stages if kind == "shared"}) + 1


def smem_bytes(n_cells: int) -> int:
    """Shared memory the kernel's blocks take for a level of n_cells cells
    (the leader's is used, every block of the launch gets as much): a
    64-bit sort word a cell, the cells rounded up to a power of two, and 8
    bytes a cell for its best value and position (csrc/select.cu's
    layout)."""
    return 8 * _words(n_cells) + 8 * n_cells


def select_keypoints_cuda(maps: Sequence[torch.Tensor], quotas: Sequence[int],
                          cells: Sequence[int], ini_th: float):
    """Launch the sm_90a kernel on the current stream."""
    global _kernel
    maps = tuple(maps)
    n = len(maps)
    if not 0 < n <= MAX_LEVELS or len(quotas) != n or len(cells) != n:
        raise ValueError(f"{n} maps (1 to {MAX_LEVELS}), {len(quotas)} "
                         f"quotas, {len(cells)} cell sizes")
    dev = maps[0].device
    for lvl, s in enumerate(maps):
        if not s.is_cuda or s.device != dev or s.dtype != torch.float32 \
                or s.dim() != 2 or not s.is_contiguous():
            raise ValueError(f"map {lvl} must be a contiguous CUDA float32 "
                             f"[H, W] tensor on {dev}, got {s.dtype} "
                             f"{tuple(s.shape)} on {s.device}")
        if s.numel() >= 2 ** 31:
            raise ValueError(f"map {lvl} {tuple(s.shape)} exceeds the "
                             f"kernel's indexing")
    if min(quotas) < 0 or min(cells) < 1:
        raise ValueError(f"quotas {tuple(quotas)}, cells {tuple(cells)}")
    n_cells = [-(-s.shape[0] // c) * -(-s.shape[1] // c)
               for s, c in zip(maps, cells)]
    smem = max(smem_bytes(k) for k in n_cells)
    if smem > MAX_SMEM:
        raise ValueError(f"{max(n_cells)} cells in a level: the kernel sorts a "
                         f"level's cells in one block's shared memory "
                         f"({smem} > {MAX_SMEM} bytes)")
    if _kernel is None:
        _kernel = cuda_build.library(_SOURCE, _SIGNATURES).airdos_select
    total = int(sum(quotas))
    offsets = [0]
    for q in quotas[:-1]:
        offsets.append(offsets[-1] + int(q))

    def ints(vals):
        return (ctypes.c_int * n)(*(int(v) for v in vals))

    xs = torch.empty(total, dtype=torch.int64, device=dev)
    ys = torch.empty(total, dtype=torch.int64, device=dev)
    resp = torch.empty(total, dtype=torch.float32, device=dev)
    with cuda_build.on_device(dev):
        err = _kernel((ctypes.c_int64 * n)(*(s.data_ptr() for s in maps)),
                      ints(s.shape[0] for s in maps),
                      ints(s.shape[1] for s in maps), ints(quotas),
                      ints(cells), ints(offsets), n, float(ini_th),
                      xs.data_ptr(), ys.data_ptr(), resp.data_ptr(), smem,
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"select kernel launch failed: cudaError {err}")
    _counter.count(cuda_build.stream_priority(dev))
    return xs, ys, resp


def select_keypoints(maps: Sequence[torch.Tensor], quotas: Sequence[int],
                     cells: Sequence[int], ini_th: float):
    """(xs, ys, response) of every level's selected keypoints, level after
    level, from the levels' detection maps: CUDA tensors go to the kernel,
    CPU tensors to the plain version."""
    if maps[0].is_cuda:
        return select_keypoints_cuda(maps, quotas, cells, ini_th)
    return select_keypoints_ref(maps, quotas, cells, ini_th)
