"""Projection-guided descriptor matching.

Rebuilds the reference's ORBmatcher::SearchByProjection family
(src/ORBmatcher.cc) as airdos_tpu does, a gated Hamming problem over
points x features:

- ``match_last_frame``: motion-model variant (ORBmatcher.cc:1328-1470) —
  window radius th*scale[last octave], forward/backward octave rules,
  right-u consistency, Hamming <= TH_HIGH, 30-bin rotation histogram.
- ``match_local_points``: track-local-map variant (ORBmatcher.cc:45-157) —
  frustum gating, predicted scale level, view-cos radius, best/second
  ratio within the same level.

The per-point prelude (projection, radius, predicted level, frustum) is
eager torch over [P] vectors; the gate, the distances, best and second,
the ratio test, the rotation histogram and the uniqueness resolution
(several points claiming one feature: the lowest distance wins, ties to
the lowest point) are one ``ops/match_kernels.match_rows`` call with the
resolve.  On the card it is one kernel launch and no [P, N] matrix is
formed; on the CPU it is the plain version.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from airdos_tpu_torch.ops.match_kernels import (LOCAL, MOTION, MatchCols,
                                                MatchRows, match_rows)
from airdos_tpu_torch.ops.match_kernels import \
    resolve_unique as _resolve_unique  # noqa: F401 (airdos_tpu's names)
from airdos_tpu_torch.ops.match_kernels import \
    rotation_consistency as _rotation_consistency  # noqa: F401

TH_HIGH = 100


class ProjMatches(NamedTuple):
    feat_idx: torch.Tensor       # [P] int64 best feature per point (-1 none)
    dist: torch.Tensor           # [P] int32 Hamming distance
    n_matches: torch.Tensor      # int64 (after uniqueness resolution)
    point_of_feat: torch.Tensor  # [N] int64 winning point per feature (-1)


def _project(R, t, xw, fx, fy, cx, cy, bf, width, height):
    xc = torch.einsum("ij,pj->pi", R, xw) + t
    z = xc[:, 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = fx * xc[:, 0] * iz + cx
    v = fy * xc[:, 1] * iz + cy
    ur = u - bf * iz
    in_img = (u >= 0) & (u < width) & (v >= 0) & (v < height) & (z > 0)
    return u, v, ur, in_img


def match_last_frame(xw, desc_p, oct_p, ang_p, valid_p,
                     R, t, feat_xy, feat_ur, feat_oct, feat_ang, feat_desc,
                     feat_valid, feat_taken,
                     fx, fy, cx, cy, bf, width, height,
                     scale_factors, th, forward: bool,
                     backward: bool) -> ProjMatches:
    """Motion-model search.  xw [P, 3] world points from the last frame
    with their descriptors/octaves/angles; feat_* are current-frame
    features."""
    u, v, ur, in_img = _project(R, t, xw, fx, fy, cx, cy, bf, width, height)

    radius = th * scale_factors[oct_p]                       # [P]
    # the feature's octave: >= the point's forward, <= it backward, else
    # within one
    band = (0, None) if forward else (None, 0) if backward else (-1, 1)
    rm = match_rows(MOTION,
                    MatchRows(desc_p, oct_p, valid_p & in_img, u, v, ur,
                              radius),
                    MatchCols(feat_desc, feat_oct, feat_valid, feat_xy[:, 0],
                              feat_xy[:, 1], feat_ur, feat_taken),
                    th=TH_HIGH, band=band, resolve=True,
                    angles=(ang_p, feat_ang), check=False)
    return ProjMatches(feat_idx=rm.feat_idx, dist=rm.dist, n_matches=rm.n,
                       point_of_feat=rm.point_of_feat)


def match_local_points(xw, desc_p, valid_p,
                       normal_p, max_dist_p, min_dist_p,
                       R, t, ow,
                       feat_xy, feat_ur, feat_oct, feat_desc, feat_valid,
                       feat_taken,
                       fx, fy, cx, cy, bf, width, height,
                       scale_factors, log_scale, n_levels, th,
                       nn_ratio=0.8) -> ProjMatches:
    """Track-local-map search (SearchByProjection with MapPoints).
    normal_p: mean viewing direction; min/max_dist: scale-invariance range;
    ow: camera centre in world."""
    u, v, ur, in_img = _project(R, t, xw, fx, fy, cx, cy, bf, width, height)

    po = xw - ow[None, :]
    dist = torch.linalg.norm(po, dim=-1)
    dist_ok = (dist >= min_dist_p) & (dist <= max_dist_p)
    safe_dist = torch.where(dist < 1e-9, torch.full_like(dist, 1e-9), dist)
    view_cos = torch.sum(po * normal_p, dim=-1) / safe_dist
    view_ok = view_cos > 0.5

    # predicted scale level (MapPoint::PredictScale)
    ratio = max_dist_p / safe_dist
    pred = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_scale) \
        .to(torch.int64)
    pred = torch.clamp(pred, 0, n_levels - 1)

    r_base = torch.where(view_cos > 0.998, 2.5, 4.0).to(xw.dtype)
    radius = th * r_base * scale_factors[pred]

    frustum = in_img & dist_ok & view_ok & valid_p
    # the feature's octave in [pred - 1, pred]; best and second at one
    # level must pass the ratio
    rm = match_rows(LOCAL,
                    MatchRows(desc_p, pred, frustum, u, v, ur, radius),
                    MatchCols(feat_desc, feat_oct, feat_valid, feat_xy[:, 0],
                              feat_xy[:, 1], feat_ur, feat_taken),
                    th=TH_HIGH, ratio=nn_ratio, band=(-1, 0), resolve=True,
                    check=False)
    return ProjMatches(feat_idx=rm.feat_idx, dist=rm.dist, n_matches=rm.n,
                       point_of_feat=rm.point_of_feat)
