"""Intensity-centroid keypoint orientation (rBRIEF's IC angle).

The reference computes per-keypoint circular-patch moments m10, m01 with
row loops (ORBextractor.cc IC_Angle, 78-105).  Here each keypoint's 31x31
patch is gathered and contracted with fixed moment kernels that are zero
outside the circle |dx| <= umax[|dy|] — the semantics of airdos_tpu's
``_angles_gather``.  The contraction runs in float64 and rounds once to
float32: every product of a float32 pixel and an integer weight is exact
in float64, and so, as long as the sum of a patch stays inside float64's
53 bits (pixels of at least 2^-8, below 2^22 in all), is their sum, in any
order.  So the moments do not depend on the order a reduction takes,
which differs between the CPU, cuBLAS and ops/orb_kernels.py's kernel;
on the integer-valued level 0 the float32 sums were already exact.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

HALF_PATCH = 15  # reference: HALF_PATCH_SIZE (ORBextractor.cc:74)


@functools.lru_cache(maxsize=1)
def _umax() -> np.ndarray:
    """Per-row circular patch half-width, exactly as the reference builds
    it (ORBextractor.cc:456-471)."""
    umax = np.zeros(HALF_PATCH + 2, np.int32)
    vmax = int(np.floor(HALF_PATCH * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(HALF_PATCH * np.sqrt(2.0) / 2))
    hp2 = HALF_PATCH * HALF_PATCH
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp2 - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[:HALF_PATCH + 1]


@functools.lru_cache(maxsize=1)
def _moment_kernels() -> np.ndarray:
    """[2, 31, 31] float32: K10[dy, dx] = dx and K01[dy, dx] = dy over the
    circular patch."""
    umax = _umax()
    size = 2 * HALF_PATCH + 1
    k = np.zeros((2, size, size), np.float32)
    for dy in range(-HALF_PATCH, HALF_PATCH + 1):
        u = umax[abs(dy)]
        for dx in range(-u, u + 1):
            k[0, dy + HALF_PATCH, dx + HALF_PATCH] = dx
            k[1, dy + HALF_PATCH, dx + HALF_PATCH] = dy
    return k


def keypoint_angles(img: torch.Tensor, xs: torch.Tensor,
                    ys: torch.Tensor) -> torch.Tensor:
    """IC angles in degrees, [0, 360) like cv::fastAtan2.

    img [H, W] f32; xs, ys [N] int64 keypoint coords at this level.  Padded
    slots give garbage angles that the validity flags mask downstream."""
    h, w = img.shape
    dy = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=img.device)
    gy = torch.clamp(ys[:, None] + dy[None, :], 0, h - 1)        # [N, 31]
    gx = torch.clamp(xs[:, None] + dy[None, :], 0, w - 1)        # [N, 31]
    patch = img[gy[:, :, None], gx[:, None, :]]                  # [N, 31, 31]
    kk = torch.as_tensor(_moment_kernels(), device=img.device)   # [2, 31, 31]
    m = torch.einsum("nij,kij->nk", patch.double(),
                     kk.double()).to(torch.float32)              # [N, 2]
    ang = torch.rad2deg(torch.atan2(m[:, 1], m[:, 0]))
    return torch.where(ang < 0, ang + 360.0, ang)
