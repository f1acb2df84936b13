"""Reprojection-based duplicate-point fusion.

Rebuild of ORBmatcher::Fuse (reference src/ORBmatcher.cc:825-975) as
airdos_tpu/matching/fuse.py computes it, written for a batch of target
keyframes (airdos_tpu vmaps it): project the candidate map points into
each target, search a 3*scale[predicted level] window at levels
[pred-1, pred+1], require Hamming <= TH_LOW and reprojection chi-square
(5.99 mono / 7.8 stereo).  The point table is shared by the batch; each
target has its own candidate mask.  The host then either merges the hit
feature's existing point or adds a new observation.

The per-(target, point) prelude (projection, right u, frustum, predicted
level and radius) is eager torch over [B, P]; the gate, the distances
and each row's best are one ``ops/match_kernels.match_rows`` call in fuse
mode: one kernel launch on the card, where no [B, P, N] tensor is
formed; on the CPU its plain version, the eager composition this module
had.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from airdos_tpu_torch.ops.match_kernels import (FUSE, MatchCols, MatchRows,
                                                match_rows)

TH_LOW = 50


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
    radius = th * scale_factors[pred]                            # [B, P]

    frustum = in_img & dist_ok & view_ok & valid_p
    rm = match_rows(FUSE, MatchRows(desc_p, pred, frustum, u, v, ur, radius),
                    MatchCols(feat_desc, feat_oct, feat_valid,
                              feat_xy[..., 0], feat_xy[..., 1], feat_ur),
                    th=TH_LOW, sigma2=sigma2)
    return FuseMatches(feat_idx=rm.feat_idx, dist=rm.dist)
