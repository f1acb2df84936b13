"""Projection-guided descriptor matching.

Rebuilds the reference's ORBmatcher::SearchByProjection family
(src/ORBmatcher.cc) as dense masked Hamming problems, as airdos_tpu does:

- ``match_last_frame``: motion-model variant (ORBmatcher.cc:1328-1470) —
  window radius th*scale[last octave], forward/backward octave rules,
  right-u consistency, Hamming <= TH_HIGH, 30-bin rotation histogram.
- ``match_local_points``: track-local-map variant (ORBmatcher.cc:45-157) —
  frustum gating, predicted scale level, view-cos radius, best/second
  ratio within the same level.

Several points claiming one feature are resolved with integer segment
min/max scatters, which are deterministic on every device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from airdos_tpu_torch.ops.hamming_kernels import hamming_matrix

TH_HIGH = 100
HISTO_BINS = 30
BIG = 1 << 10


class ProjMatches(NamedTuple):
    feat_idx: torch.Tensor       # [P] int64 best feature per point (-1 none)
    dist: torch.Tensor           # [P] int32 Hamming distance
    n_matches: torch.Tensor      # int64 (after uniqueness resolution)
    point_of_feat: torch.Tensor  # [N] int64 winning point per feature (-1)


def _resolve_unique(best_feat, best_dist, has, n_feats: int):
    """Each feature keeps only the lowest-distance claiming point; ties go
    to the lowest point index."""
    P = best_feat.shape[0]
    dev = best_feat.device
    park = torch.full_like(best_feat, n_feats)      # invalid -> slot n_feats
    feat_safe = torch.where(has, best_feat, park)
    seg_min = torch.full((n_feats + 1,), BIG, dtype=best_dist.dtype, device=dev)
    seg_min = seg_min.scatter_reduce(0, feat_safe, best_dist, "amin",
                                     include_self=True)
    is_winner = has & (best_dist == seg_min[feat_safe])
    pid = torch.arange(P, dtype=torch.int64, device=dev)
    seg_pid = torch.full((n_feats + 1,), P, dtype=torch.int64, device=dev)
    seg_pid = seg_pid.scatter_reduce(0, torch.where(is_winner, feat_safe, park),
                                     pid, "amin", include_self=True)
    final = is_winner & (seg_pid[feat_safe] == pid)
    feat_idx = torch.where(final, best_feat, torch.full_like(best_feat, -1))
    point_of_feat = torch.full((n_feats + 1,), -1, dtype=torch.int64, device=dev)
    point_of_feat = point_of_feat.scatter_reduce(
        0, torch.where(final, feat_safe, park), pid, "amax",
        include_self=True)[:n_feats]
    return feat_idx, point_of_feat, torch.sum(final)


def _rotation_consistency(ang_ref, ang_cur, has):
    """Keep only matches in the 3 dominant rotation-histogram bins
    (ORBmatcher::ComputeThreeMaxima semantics, 1601-1645)."""
    rot = ang_ref - ang_cur
    rot = torch.where(rot < 0, rot + 360.0, rot)
    binf = torch.round(rot * (HISTO_BINS / 360.0))
    bins = torch.where(binf == HISTO_BINS, torch.zeros_like(binf), binf) \
        .to(torch.int64)
    bins = torch.clamp(bins, 0, HISTO_BINS - 1)
    counts = torch.zeros(HISTO_BINS, dtype=torch.int64, device=has.device)
    counts.index_add_(0, torch.where(has, bins, torch.zeros_like(bins)),
                      has.to(torch.int64))
    # top 3 bins, ties to the lower bin (jax.lax.top_k's order)
    top3 = torch.sort(counts, descending=True, stable=True)
    top3_vals, top3_idx = top3.values[:3], top3.indices[:3]
    # the reference drops bins with count < 0.1 * max
    ok = top3_vals.to(torch.float32) >= 0.1 * top3_vals[0].to(torch.float32)
    keep_bin = torch.zeros(HISTO_BINS, dtype=torch.bool, device=has.device)
    keep_bin[top3_idx] = ok
    return has & keep_bin[bins]


def _project(R, t, xw, fx, fy, cx, cy, bf, width, height):
    xc = torch.einsum("ij,pj->pi", R, xw) + t
    z = xc[:, 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = fx * xc[:, 0] * iz + cx
    v = fy * xc[:, 1] * iz + cy
    ur = u - bf * iz
    in_img = (u >= 0) & (u < width) & (v >= 0) & (v < height) & (z > 0)
    return u, v, ur, in_img


def _gated_hamming(ok, desc_p, feat_desc):
    D = hamming_matrix(desc_p, feat_desc)
    return torch.where(ok, D, torch.full_like(D, BIG))


def match_last_frame(xw, desc_p, oct_p, ang_p, valid_p,
                     R, t, feat_xy, feat_ur, feat_oct, feat_ang, feat_desc,
                     feat_valid, feat_taken,
                     fx, fy, cx, cy, bf, width, height,
                     scale_factors, th, forward: bool,
                     backward: bool) -> ProjMatches:
    """Motion-model search.  xw [P, 3] world points from the last frame
    with their descriptors/octaves/angles; feat_* are current-frame
    features."""
    N = feat_xy.shape[0]
    u, v, ur, in_img = _project(R, t, xw, fx, fy, cx, cy, bf, width, height)

    radius = th * scale_factors[oct_p]                       # [P]
    du = torch.abs(feat_xy[None, :, 0] - u[:, None])
    dv = torch.abs(feat_xy[None, :, 1] - v[:, None])
    win_ok = (du < radius[:, None]) & (dv < radius[:, None])

    lo = oct_p[:, None]
    lf = feat_oct[None, :]
    if forward:
        oct_ok = lf >= lo
    elif backward:
        oct_ok = lf <= lo
    else:
        oct_ok = (lf >= lo - 1) & (lf <= lo + 1)

    r_ok = torch.where(feat_ur[None, :] > 0,
                       torch.abs(ur[:, None] - feat_ur[None, :]) < radius[:, None],
                       torch.ones_like(win_ok))

    ok = (win_ok & oct_ok & r_ok & valid_p[:, None] & in_img[:, None] &
          feat_valid[None, :] & ~feat_taken[None, :])
    D = _gated_hamming(ok, desc_p, feat_desc)
    best_feat = torch.argmin(D, dim=1)
    best_dist = torch.gather(D, 1, best_feat[:, None])[:, 0]
    has = best_dist <= TH_HIGH
    has = _rotation_consistency(ang_p, feat_ang[best_feat], has)

    feat_idx, point_of_feat, n = _resolve_unique(best_feat, best_dist, has, N)
    return ProjMatches(feat_idx=feat_idx, dist=best_dist, n_matches=n,
                       point_of_feat=point_of_feat)


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
    P = xw.shape[0]
    N = feat_xy.shape[0]
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

    du = torch.abs(feat_xy[None, :, 0] - u[:, None])
    dv = torch.abs(feat_xy[None, :, 1] - v[:, None])
    win_ok = (du < radius[:, None]) & (dv < radius[:, None])
    lf = feat_oct[None, :]
    oct_ok = (lf >= pred[:, None] - 1) & (lf <= pred[:, None])
    r_ok = torch.where(feat_ur[None, :] > 0,
                       torch.abs(ur[:, None] - feat_ur[None, :]) < radius[:, None],
                       torch.ones_like(win_ok))
    frustum = in_img & dist_ok & view_ok & valid_p
    ok = (win_ok & oct_ok & r_ok & frustum[:, None] &
          feat_valid[None, :] & ~feat_taken[None, :])

    D = _gated_hamming(ok, desc_p, feat_desc)
    best_feat = torch.argmin(D, dim=1)
    best_dist = torch.gather(D, 1, best_feat[:, None])[:, 0]
    best_lvl = feat_oct[best_feat]
    D2 = D.clone()
    D2[torch.arange(P, device=D.device), best_feat] = BIG
    second_feat = torch.argmin(D2, dim=1)
    second_dist = torch.gather(D2, 1, second_feat[:, None])[:, 0]
    second_lvl = feat_oct[second_feat]

    ratio_rej = (best_lvl == second_lvl) & \
        (best_dist.to(torch.float32) > nn_ratio * second_dist.to(torch.float32)) & \
        (second_dist < BIG)
    has = (best_dist <= TH_HIGH) & ~ratio_rej

    feat_idx, point_of_feat, n = _resolve_unique(best_feat, best_dist, has, N)
    return ProjMatches(feat_idx=feat_idx, dist=best_dist, n_matches=n,
                       point_of_feat=point_of_feat)
