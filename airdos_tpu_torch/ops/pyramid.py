"""Scale pyramid with parallel mask pyramid.

Behavioral equivalent of the reference's ComputePyramid
(ORBextractor.cc:1121-1156): ``n_levels`` levels at scale factor ~1.2, and
the AirDOS mask pyramid where the level-0 mask is eroded 10x10 before
downscaling.  Each level is resized from the previous one.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from airdos_tpu_torch.ops.filters import erode, resize_bilinear

def level_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> List[Tuple[int, int]]:
    shapes = []
    for lvl in range(n_levels):
        s = 1.0 / (scale_factor ** lvl)
        shapes.append((int(round(h * s)), int(round(w * s))))
    return shapes


class Pyramid(NamedTuple):
    images: Tuple[torch.Tensor, ...]         # per-level [h_l, w_l] float32
    masks: Tuple[torch.Tensor, ...]          # per-level [h_l, w_l] float32 (1 = usable)
    scales: Tuple[float, ...]                # factor ** lvl


def build_pyramid(img: torch.Tensor,
                  mask: Optional[torch.Tensor],
                  n_levels: int = 8,
                  scale_factor: float = 1.2,
                  mask_erode: int = 10) -> Pyramid:
    """img: [H, W] float32.  mask: [H, W] with 1 = usable pixel, or None
    for no masking."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale_factor)
    if mask is None:
        m0 = torch.ones((h, w), dtype=torch.float32, device=img.device)
    else:
        m0 = erode(mask.to(torch.float32), mask_erode)
    images = [img]
    masks = [m0]
    for lvl in range(1, n_levels):
        hl, wl = shapes[lvl]
        images.append(resize_bilinear(images[-1], hl, wl))
        masks.append((resize_bilinear(masks[-1], hl, wl) > 0.999).to(torch.float32))
    scales = tuple(scale_factor ** lvl for lvl in range(n_levels))
    return Pyramid(tuple(images), tuple(masks), scales)
