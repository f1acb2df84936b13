"""FAST-16 segment-test corner scores, dense over a pyramid level.

Behavioral equivalent of the reference's per-cell cv::FAST calls
(ORBextractor.cc:767-864), computed for every pixel at once from 16
shifted copies of the image.  The score is OpenCV's: the largest threshold
at which 9 contiguous circle pixels are all brighter than p+t or all
darker than p-t.  A pixel is a corner at threshold t iff score > t.

The extractor calls ``fast_nms_levels`` once an image: each pyramid
level's scores, multiplied by the mask, zeroed outside the detection
border, thresholded and non-max suppressed; ``fast_nms`` is the one-level
case.  On CUDA tensors they launch the sm_90a kernel of ``csrc/fast.cu``
(one launch for all the levels, at most ``MAX_LEVELS``, their maps views
into one buffer) on the calling thread's current stream (built with nvcc
at first use into ``airdos_tpu_torch/_build/``, bound through ctypes) or
raise, and count the launch, by thread and stream priority too; on CPU
tensors they run ``fast_nms_levels_ref`` / ``fast_nms_ref``, the plain
composition of ``fast_score_map`` and ``nms_strict``.  The kernel design
and what bounds it are described at the top of the CUDA source;
``level_table`` and ``block_tile`` are the kernel's level table and the
tile a block finds in it.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from airdos_tpu_torch.ops import cuda_build

# OpenCV's Bresenham circle of radius 3, clockwise from (0, -3): (dx, dy).
CIRCLE = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], np.int32)

ARC_LEN = 9  # contiguous arc length for FAST-9/16


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx], wrapping (callers invalidate a 3 px
    border)."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9/16 response.  img [H, W] float32 (0..255) -> [H, W]
    float32, 0 where no threshold passes and on the 3 px border."""
    diffs = torch.stack(
        [_shift2d(img, int(dy), int(dx)) - img for dx, dy in CIRCLE], dim=0)
    d = torch.cat([diffs, diffs[:ARC_LEN - 1]], dim=0)   # circular pad

    lo = d[:16]
    hi = d[:16]
    for s in range(1, ARC_LEN):
        lo = torch.minimum(lo, d[s:s + 16])
        hi = torch.maximum(hi, d[s:s + 16])
    bright = torch.amax(lo, dim=0)       # max over arc starts of min over arc
    dark = -torch.amin(hi, dim=0)
    score = torch.clamp(torch.maximum(bright, dark), min=0.0)

    h, w = img.shape
    out = torch.zeros_like(score)
    out[3:h - 3, 3:w - 3] = score[3:h - 3, 3:w - 3]
    return out


def nms_strict(score: torch.Tensor) -> torch.Tensor:
    """Non-max suppression matching cv2.FAST: keep a pixel only if its
    score is strictly greater than all 8 neighbours'.  Threshold BEFORE
    calling."""
    m = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = _shift2d(score, dy, dx)
            m = n if m is None else torch.maximum(m, n)
    return torch.where(score > m, score, torch.zeros_like(score))


def fast_nms_ref(img: torch.Tensor, mask: torch.Tensor, min_th: float,
                 border: int) -> torch.Tensor:
    """Plain torch version of one level's detection map: nms_strict of the
    FAST scores times the mask, zeroed outside [border, dim - border) and
    at or below min_th.  img, mask [H, W] float32 -> [H, W] float32."""
    h, w = img.shape
    score = fast_score_map(img) * mask
    inside = torch.zeros_like(score)
    inside[border:h - border, border:w - border] = 1.0
    zero = torch.zeros_like(score)
    score = torch.where(inside > 0, score, zero)
    return nms_strict(torch.where(score > min_th, score, zero))


def fast_nms_levels_ref(images: Sequence[torch.Tensor],
                        masks: Sequence[torch.Tensor], min_th: float,
                        border: int) -> Tuple[torch.Tensor, ...]:
    """Plain torch version of an image's detection maps: fast_nms_ref of
    each level."""
    return tuple(fast_nms_ref(img, mask, min_th, border)
                 for img, mask in zip(images, masks))


MAX_LEVELS = 16                  # the kernel's level table
TILE = 32                        # a block's output tile edge

_SOURCE = cuda_build.CSRC / "fast.cu"
_I32P = ctypes.POINTER(ctypes.c_int)
_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "airdos_fast_nms": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "airdos_fast_nms_levels": [_I64P] * 3 + [_I32P] * 2 + [ctypes.c_int]
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}
_lib = None                      # the loaded library, once built

_counter = cuda_build.LaunchCounter()


def launches() -> int:
    """Kernel launches since the last reset_launches()."""
    return _counter.total


def launch_tally() -> dict:
    """{("fast_nms", thread name, stream priority): launches} since the
    last reset_launches()."""
    return {("fast_nms",) + key: n for key, n in _counter.tally().items()}


def reset_launches() -> None:
    _counter.reset()


def build():
    """Compile csrc/fast.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def _library():
    global _lib
    if _lib is None:
        _lib = cuda_build.library(_SOURCE, _SIGNATURES)
    return _lib


def level_table(shapes: Sequence[Tuple[int, int]]):
    """The kernel's level table for levels of these [h, w] shapes: the
    first tile of each level in the launch's order with, last, the launch's
    blocks (a tile a block), and each level's tiles across, as the C entry
    point fills them."""
    first, tiles_x, at = [], [], 0
    for h, w in shapes:
        across = -(-w // TILE) if w > 0 else 0
        first.append(at)
        tiles_x.append(across)
        if h > 0 and w > 0:
            at += across * -(-h // TILE)
    return first + [at], tiles_x


def block_tile(block: int, first: Sequence[int],
               tiles_x: Sequence[int]) -> Tuple[int, int, int]:
    """(level, y0, x0) of the tile block `block` computes: csrc/fast.cu's
    walk of the level table (the last level whose first tile is at most
    the block; a level without tiles shares its first tile with the
    next)."""
    lvl = 0
    for i in range(1, len(tiles_x)):
        if block >= first[i]:
            lvl = i
    tile = block - first[lvl]
    return lvl, (tile // tiles_x[lvl]) * TILE, (tile % tiles_x[lvl]) * TILE


def _check_level(lvl, img, mask, device) -> None:
    for name, x in (("img", img), ("mask", mask)):
        if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2 \
                or not x.is_contiguous() or x.device != device:
            raise ValueError(f"{name} of level {lvl} must be a contiguous "
                             f"CUDA float32 [H, W] tensor on {device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if mask.shape != img.shape:
        raise ValueError(f"mask {tuple(mask.shape)} for img "
                         f"{tuple(img.shape)} at level {lvl}")
    if img.numel() >= 2 ** 31:
        raise ValueError(f"{tuple(img.shape)} level exceeds the kernel's "
                         f"indexing")


def _check_border(border: int) -> None:
    if border < 3:
        raise ValueError(f"border {border} < 3, the FAST circle's radius")


def fast_nms_cuda(img: torch.Tensor, mask: torch.Tensor, min_th: float,
                  border: int) -> torch.Tensor:
    """Launch the sm_90a kernel on the current stream for one level."""
    if not img.is_cuda:
        raise ValueError(f"img must be a CUDA tensor, got {img.device}")
    _check_level(0, img, mask, img.device)
    _check_border(border)
    h, w = img.shape
    kernel = _library().airdos_fast_nms
    out = torch.empty_like(img)
    with cuda_build.on_device(img.device):
        err = kernel(img.data_ptr(), mask.data_ptr(), out.data_ptr(), h, w,
                     float(min_th), int(border),
                     torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fast_nms kernel launch failed: cudaError {err}")
    _counter.count(cuda_build.stream_priority(img.device))
    return out


def fast_nms_levels_cuda(images: Sequence[torch.Tensor],
                         masks: Sequence[torch.Tensor], min_th: float,
                         border: int) -> Tuple[torch.Tensor, ...]:
    """Launch the sm_90a kernel on the current stream for all the levels
    at once; the maps are views into one buffer."""
    images, masks = tuple(images), tuple(masks)
    n = len(images)
    if not 0 < n <= MAX_LEVELS or len(masks) != n:
        raise ValueError(f"{n} levels (1 to {MAX_LEVELS}), {len(masks)} "
                         f"masks")
    dev = images[0].device
    if not images[0].is_cuda:
        raise ValueError(f"the levels must be CUDA tensors, got {dev}")
    for lvl, (img, mask) in enumerate(zip(images, masks)):
        _check_level(lvl, img, mask, dev)
    _check_border(border)
    shapes = [tuple(x.shape) for x in images]
    kernel = _library().airdos_fast_nms_levels
    maps = cuda_build.level_views(shapes, dev)

    def ptrs(xs):
        return (ctypes.c_int64 * n)(*(x.data_ptr() for x in xs))

    def ints(vals):
        return (ctypes.c_int * n)(*(int(v) for v in vals))

    with cuda_build.on_device(dev):
        err = kernel(ptrs(images), ptrs(masks), ptrs(maps),
                     ints(h for h, _ in shapes), ints(w for _, w in shapes),
                     n, float(min_th), int(border),
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fast_nms kernel launch failed: cudaError {err}")
    _counter.count(cuda_build.stream_priority(dev))
    return maps


def fast_nms(img: torch.Tensor, mask: torch.Tensor, min_th: float,
             border: int) -> torch.Tensor:
    """One level's detection map (fast_nms_ref's): CUDA tensors go to the
    kernel, CPU tensors to the plain version."""
    if img.is_cuda:
        return fast_nms_cuda(img, mask, min_th, border)
    return fast_nms_ref(img, mask, min_th, border)


def fast_nms_levels(images: Sequence[torch.Tensor],
                    masks: Sequence[torch.Tensor], min_th: float,
                    border: int) -> Tuple[torch.Tensor, ...]:
    """The detection maps of an image's levels images[l] [H_l, W_l]
    float32 with their masks masks[l]: CUDA tensors go to the kernel (one
    launch), CPU tensors to the plain version."""
    if images[0].is_cuda:
        return fast_nms_levels_cuda(images, masks, min_th, border)
    return fast_nms_levels_ref(images, masks, min_th, border)
