"""Epipolar-constrained matching + two-view triangulation of new map points.

Rebuild of LocalMapping::CreateNewMapPoints (reference
src/LocalMapping.cc:221-466) and ORBmatcher::SearchForTriangulation
(src/ORBmatcher.cc:657-823) as airdos_tpu/matching/epipolar.py computes
it, written for a batch of neighbours: the new keyframe (KF1) against B
neighbour keyframes (KF2) at once, where airdos_tpu vmaps the pair
function.  For each pair, features without a map point are matched under
the epipolar constraint (distance to the epipolar line < 3.84 sigma^2)
with Hamming < TH_LOW, then triangulated linearly and validated
(parallax, positive depth in both views, reprojection chi2, scale
consistency).  Stereo depth wins over triangulation at low parallax.

The per-pair geometry (F12, the lines, the epipole, the camera centres)
is a handful of small eager ops; the search is one launch of match_rows
in epipolar mode (ops/match_kernels.py: the gate, the gated pairs'
distances and each row's argmin, no [B, N1, N2] matrix), and the rest
one launch of triangulate (ops/triangulate_kernels.py).
"""
from __future__ import annotations

import torch

from airdos_tpu_torch.geometry.se3 import so3_hat
from airdos_tpu_torch.ops.match_kernels import (EPIPOLAR, MatchCols,
                                                MatchRows, match_rows)
from airdos_tpu_torch.ops.triangulate_kernels import (TH_LOW,
                                                      TriangulationResult,
                                                      triangulate_rows)

_kinv = {}                       # (fx, fy, cx, cy, dtype, device) -> K^-1


def _inverse_intrinsics(fx, fy, cx, cy, dt, dev) -> torch.Tensor:
    """K^-1 on the device, made once (a host-to-device copy waits for the
    stream)."""
    key = (fx, fy, cx, cy, dt, dev)
    kinv = _kinv.get(key)
    if kinv is None:
        kinv = _kinv[key] = torch.tensor([[1 / fx, 0, -cx / fx],
                                          [0, 1 / fy, -cy / fy],
                                          [0, 0, 1]], dtype=dt, device=dev)
    return kinv


def triangulate_pair(
        # KF1 (the new keyframe), shared by the batch
        xy1, oct1, ur1, depth1, desc1, free1,
        R1, t1,
        # KF2 (the neighbours), each with a leading batch axis [B, ...]
        xy2, oct2, ur2, depth2, desc2, free2,
        R2, t2,
        fx, fy, cx, cy, bf,
        scale_factors, sigma2, log_scale, n_levels) -> TriangulationResult:
    """free*: feature has no associated map point.  Poses are Tcw.
    Octaves are int64 index tensors; n_levels is unused (kept for the
    signature of airdos_tpu)."""
    N1 = xy1.shape[0]
    dt, dev = xy1.dtype, xy1.device

    # ---- epipolar geometry (F12 from relative pose) -------------------
    R12 = R1 @ R2.transpose(-1, -2)                              # [B, 3, 3]
    t12 = t1 - torch.einsum("bij,bj->bi", R12, t2)
    Kinv = _inverse_intrinsics(fx, fy, cx, cy, dt, dev)
    F12 = Kinv.T @ so3_hat(t12) @ R12 @ Kinv                     # [B, 3, 3]
    p1h = torch.cat([xy1, torch.ones((N1, 1), dtype=dt, device=dev)], dim=1)
    lines = p1h @ F12                                            # [B, N1, 3]

    # epipole in image 2: project camera-1 centre; reject matches too
    # close to it (mono only in reference): a flag of each column
    C1 = -R1.T @ t1
    e2c = torch.einsum("bij,j->bi", R2, C1) + t2
    e2z = torch.where(torch.abs(e2c[:, 2]) < 1e-9,
                      torch.full_like(e2c[:, 2], 1e-9), e2c[:, 2])
    ex = fx * e2c[:, 0] / e2z + cx
    ey = fy * e2c[:, 1] / e2z + cy
    de2 = (xy2[..., 0] - ex[:, None]) ** 2 + (xy2[..., 1] - ey[:, None]) ** 2
    epi_far = de2 > 100.0 * scale_factors[oct2]
    m = match_rows(EPIPOLAR, MatchRows(desc1, oct1, free1, line=lines),
                   MatchCols(desc2, oct2, free2 & ((ur2 >= 0) | epi_far),
                             xy2[..., 0], xy2[..., 1], sigma2[oct2]),
                   TH_LOW - 1)

    # ---- triangulate ---------------------------------------------------
    C2w = -torch.einsum("bji,bj->bi", R2, t2)
    return triangulate_rows(m.best, m.dist, xy1, oct1, ur1, depth1, R1, t1,
                            xy2, oct2, ur2, depth2, R2, t2, C1, C2w,
                            fx, fy, cx, cy, bf, scale_factors, sigma2,
                            log_scale)
