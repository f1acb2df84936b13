"""Sim3-guided mutual matching (SearchBySim3).

Rebuild of ORBmatcher::SearchBySim3 (reference src/ORBmatcher.cc:
1102-1326) as airdos_tpu/matching/sim3_match.py computes it: after a
RANSAC Sim3 between two keyframes, project each keyframe's map points
into the other camera through S12 / S21, gate by the scale-predicted
window (th = 7.5 * scale[level]), take the best Hamming match under
TH_HIGH in each direction, and keep the mutually agreeing pairs.  Each
direction is one match_rows call in motion mode (ops/match_kernels.py:
the square window strictly inside the radius, the octave band [pred - 1,
pred], no right-u gate, the best distance <= TH_HIGH; one launch on the
card, no [P, N] matrix); the agreement is a gather-compare.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from airdos_tpu_torch.ops.match_kernels import (MOTION, MatchCols,
                                                MatchRows, match_rows)

TH_HIGH = 100


class Sim3Matches(NamedTuple):
    idx2_of_1: torch.Tensor   # [N1] mutual match in KF2 (-1 none)
    n_matches: torch.Tensor


def _directional(x_in_cam, valid_p, desc_p, maxd_p,
                 feat_xy, feat_oct, feat_desc, feat_valid,
                 fx, fy, cx, cy, width, height,
                 scale_factors, log_scale, n_levels, th):
    """Best target feature per source point (points already in the target
    camera frame): best feature index [P] and whether it counts."""
    z = x_in_cam[:, 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = fx * x_in_cam[:, 0] * iz + cx
    v = fy * x_in_cam[:, 1] * iz + cy
    in_img = (u >= 0) & (u < width) & (v >= 0) & (v < height) & (z > 0)

    dist = torch.linalg.norm(x_in_cam, dim=-1)
    # PredictScale from the point's max scale-invariance distance
    ratio = maxd_p / torch.where(dist < 1e-9, torch.full_like(dist, 1e-9), dist)
    pred = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_scale)
    pred = torch.clamp(pred, 0, n_levels - 1).to(torch.int64)
    dist_ok = (dist >= 0.8 * torch.where(maxd_p > 0, maxd_p,
                                         torch.full_like(maxd_p, 1e9)) /
               scale_factors[n_levels - 1]) & (dist <= 1.2 * maxd_p)

    # the window |x - u| < r, |y - v| < r, octaves [pred - 1, pred]; the
    # right u's all 0: no right-u gate
    zeros_p = torch.zeros_like(u)
    m = match_rows(MOTION,
                   MatchRows(desc_p, pred, valid_p & in_img & dist_ok, u, v,
                             zeros_p, th * scale_factors[pred]),
                   MatchCols(feat_desc, feat_oct, feat_valid, feat_xy[:, 0],
                             feat_xy[:, 1], torch.zeros_like(feat_xy[:, 0])),
                   TH_HIGH, band=(-1, 0))
    return m.best, m.has


def match_by_sim3(x2_in_c1, valid2, desc2, maxd2,
                  x1_in_c2, valid1, desc1, maxd1,
                  feat1_xy, feat1_oct, feat1_desc, feat1_valid,
                  feat2_xy, feat2_oct, feat2_desc, feat2_valid,
                  fx, fy, cx, cy, width, height,
                  scale_factors, log_scale, n_levels,
                  th: float = 7.5) -> Sim3Matches:
    """x2_in_c1: KF2's per-feature map points in camera 1 (S12 * T2w);
    x1_in_c2: KF1's points in camera 2.  desc*/maxd* are the POINTS'
    descriptors / max scale distances laid out per feature slot; valid*
    marks slots carrying a live, not-yet-matched point."""
    # direction A: KF2 points -> KF1 features; bestA [N2]
    bestA, hasA = _directional(x2_in_c1, valid2, desc2, maxd2,
                               feat1_xy, feat1_oct, feat1_desc, feat1_valid,
                               fx, fy, cx, cy, width, height,
                               scale_factors, log_scale, n_levels, th)
    # direction B: KF1 points -> KF2 features; bestB [N1]
    bestB, hasB = _directional(x1_in_c2, valid1, desc1, maxd1,
                               feat2_xy, feat2_oct, feat2_desc, feat2_valid,
                               fx, fy, cx, cy, width, height,
                               scale_factors, log_scale, n_levels, th)
    # mutual agreement: bestA[bestB[f1]] == f1
    f1 = torch.arange(x1_in_c2.shape[0], device=bestB.device)
    agree = hasB & hasA[bestB] & (bestA[bestB] == f1)
    idx2 = torch.where(agree, bestB, torch.full_like(bestB, -1))
    return Sim3Matches(idx2_of_1=idx2, n_matches=torch.sum(agree))
