"""Reprojection-based duplicate-point fusion.

Rebuild of ORBmatcher::Fuse (reference src/ORBmatcher.cc:825-975) as
airdos_tpu/matching/fuse.py computes it, written for a batch of target
keyframes (airdos_tpu vmaps it): project the candidate map points into
each target, search a 3*scale[predicted level] window at levels
[pred-1, pred+1], require Hamming <= TH_LOW and reprojection chi-square
(5.99 mono / 7.8 stereo).  The point table is shared by the batch; each
target has its own candidate mask.  The host then either merges the hit
feature's existing point or adds a new observation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from airdos_tpu_torch.ops.hamming_kernels import hamming_matrix_batched

TH_LOW = 50
BIG = 1 << 10


class FuseMatches(NamedTuple):
    feat_idx: torch.Tensor   # [B, P] best feature in the target (-1 none)
    dist: torch.Tensor       # [B, P]


def fuse_candidates(xw, desc_p, valid_p, normal_p, max_dist_p, min_dist_p,
                    R, t, ow,
                    feat_xy, feat_ur, feat_oct, feat_desc, feat_valid,
                    fx, fy, cx, cy, bf, width, height,
                    scale_factors, sigma2, log_scale, n_levels,
                    th: float = 3.0) -> FuseMatches:
    """Shared: xw [P, 3], desc_p [P, 8], normal_p, max/min_dist_p.  Per
    target (leading axis B): valid_p [B, P], R [B, 3, 3], t, ow [B, 3],
    feat_xy [B, N, 2], feat_ur, feat_oct (int64), feat_valid [B, N],
    feat_desc [B, N, 8]."""
    xc = torch.einsum("bij,pj->bpi", R, xw) + t[:, None, :]      # [B, P, 3]
    z = xc[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = fx * xc[..., 0] * iz + cx
    v = fy * xc[..., 1] * iz + cy
    ur = u - bf * iz
    in_img = (u >= 0) & (u < width) & (v >= 0) & (v < height) & (z > 0)

    po = xw[None] - ow[:, None, :]
    dist3d = torch.linalg.norm(po, dim=-1)                       # [B, P]
    dist_ok = (dist3d >= min_dist_p) & (dist3d <= max_dist_p)
    safe = torch.clamp(dist3d, min=1e-9)
    view_cos = torch.sum(po * normal_p[None], dim=-1) / safe
    view_ok = view_cos > 0.5

    ratio = max_dist_p / safe
    pred = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_scale) \
        .to(torch.int64)
    pred = torch.clamp(pred, 0, n_levels - 1)
    radius = (th * scale_factors[pred])[..., None]               # [B, P, 1]

    du = feat_xy[:, None, :, 0] - u[..., None]                   # [B, P, N]
    dv = feat_xy[:, None, :, 1] - v[..., None]
    win_ok = (torch.abs(du) < radius) & (torch.abs(dv) < radius)
    lf = feat_oct[:, None, :]
    oct_ok = (lf >= pred[..., None] - 1) & (lf <= pred[..., None] + 1)

    # reprojection chi2 per candidate pair
    s2 = sigma2[feat_oct][:, None, :]
    e2 = du * du + dv * dv
    der = feat_ur[:, None, :] - ur[..., None]
    has_r = (feat_ur >= 0)[:, None, :]
    chi = torch.where(has_r, (e2 + der * der) / s2, e2 / s2)
    chi_ok = torch.where(has_r, chi <= 7.8, chi <= 5.99)

    frustum = in_img & dist_ok & view_ok & valid_p
    ok = win_ok & oct_ok & chi_ok & frustum[..., None] & feat_valid[:, None, :]
    D = hamming_matrix_batched(desc_p[None], feat_desc)
    D = torch.where(ok, D, torch.full_like(D, BIG))
    best = torch.argmin(D, dim=2)
    bdist = torch.gather(D, 2, best[..., None])[..., 0]
    feat_idx = torch.where(bdist <= TH_LOW, best, torch.full_like(best, -1))
    return FuseMatches(feat_idx=feat_idx, dist=bdist)
