"""FAST-16 segment-test corner scores, dense over a pyramid level.

Behavioral equivalent of the reference's per-cell cv::FAST calls
(ORBextractor.cc:767-864), computed for every pixel at once from 16
shifted copies of the image.  The score is OpenCV's: the largest threshold
at which 9 contiguous circle pixels are all brighter than p+t or all
darker than p-t.  A pixel is a corner at threshold t iff score > t.
"""
from __future__ import annotations

import numpy as np
import torch

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
