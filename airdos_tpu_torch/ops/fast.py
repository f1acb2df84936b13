"""FAST-16 segment-test corner scores, dense over a pyramid level.

Behavioral equivalent of the reference's per-cell cv::FAST calls
(ORBextractor.cc:767-864), computed for every pixel at once from 16
shifted copies of the image.  The score is OpenCV's: the largest threshold
at which 9 contiguous circle pixels are all brighter than p+t or all
darker than p-t.  A pixel is a corner at threshold t iff score > t.

The extractor calls ``fast_nms``: one pyramid level's scores, multiplied
by the mask, zeroed outside the detection border, thresholded and
non-max suppressed.  On a CUDA tensor it launches the sm_90a kernel of
``csrc/fast.cu`` on the calling thread's current stream (built with nvcc
at first use into ``airdos_tpu_torch/_build/``, bound through ctypes) or
raises, and counts the launch, by thread and stream priority too; on a
CPU tensor it runs ``fast_nms_ref``, the plain composition of
``fast_score_map`` and ``nms_strict``.  The kernel design and what bounds
it are described at the top of the CUDA source.
"""
from __future__ import annotations

import ctypes

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


_SOURCE = cuda_build.CSRC / "fast.cu"
_SIGNATURES = {
    "airdos_fast_nms": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}
_kernel = None                   # the bound C entry point, once loaded

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


def fast_nms_cuda(img: torch.Tensor, mask: torch.Tensor, min_th: float,
                  border: int) -> torch.Tensor:
    """Launch the sm_90a kernel on the current stream."""
    global _kernel
    for name, x in (("img", img), ("mask", mask)):
        if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2 \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA float32 "
                             f"[H, W] tensor, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if mask.device != img.device or mask.shape != img.shape:
        raise ValueError(f"mask {tuple(mask.shape)} on {mask.device} for "
                         f"img {tuple(img.shape)} on {img.device}")
    if border < 3:
        raise ValueError(f"border {border} < 3, the FAST circle's radius")
    h, w = img.shape
    if h * w >= 2 ** 31:
        raise ValueError(f"{h}x{w} image exceeds the kernel's indexing")
    if _kernel is None:
        _kernel = cuda_build.library(_SOURCE, _SIGNATURES).airdos_fast_nms
    out = torch.empty_like(img)
    with cuda_build.on_device(img.device):
        err = _kernel(img.data_ptr(), mask.data_ptr(), out.data_ptr(), h, w,
                      float(min_th), int(border),
                      torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fast_nms kernel launch failed: cudaError {err}")
    _counter.count(cuda_build.stream_priority(img.device))
    return out


def fast_nms(img: torch.Tensor, mask: torch.Tensor, min_th: float,
             border: int) -> torch.Tensor:
    """One level's detection map (fast_nms_ref's): CUDA tensors go to the
    kernel, CPU tensors to the plain version."""
    if img.is_cuda:
        return fast_nms_cuda(img, mask, min_th, border)
    return fast_nms_ref(img, mask, min_th, border)
