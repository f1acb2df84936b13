"""Fused per-frame tracking step.

One call runs the whole tracked frame on the device: the stereo front end
of both images, the motion-model projection match (with the reference's
x2-window retry) and pose LM, then the local-map projection match and pose
LM.  The device result leaves in one copy of one packed int32 tensor.

Two host syncs happen per step and no others: the read of the motion
match count that decides the retry (a ``lax.cond`` in airdos_tpu), and the
final copy of the packed result.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from airdos_tpu_torch.matching.projection import (match_last_frame,
                                                  match_local_points)
from airdos_tpu_torch.solvers.pose_opt import pose_optimize


class TrackStepResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    point_of_feat: torch.Tensor   # [N] source index (-1 none); post-opt inliers only
    n_matches: torch.Tensor       # matches before optimization
    n_real_inliers: torch.Tensor  # inliers to real map points


def motion_model_step(xw_p, desc_p, oct_p, ang_p, valid_p, real_p,
                      R0, t0,
                      feat_xy_un, feat_ur, feat_oct, feat_ang, feat_desc,
                      feat_valid, inv_sigma2_feat,
                      fx, fy, cx, cy, bf, width, height,
                      scale_factors, th, forward, backward,
                      prior_w_rot=0.0, prior_w_trans=0.0) -> TrackStepResult:
    """SearchByProjection(cur, last, th) + PoseOptimization."""
    taken = torch.zeros(feat_xy_un.shape[0], dtype=torch.bool,
                        device=feat_xy_un.device)
    m = match_last_frame(xw_p, desc_p, oct_p, ang_p, valid_p,
                         R0, t0, feat_xy_un, feat_ur, feat_oct, feat_ang,
                         feat_desc, feat_valid, taken,
                         fx, fy, cx, cy, bf, width, height,
                         scale_factors, th, forward, backward)
    pof = m.point_of_feat
    has = pof >= 0
    src = torch.clamp(pof, min=0)
    obs = torch.cat([feat_xy_un, feat_ur[:, None]], dim=1)
    res = pose_optimize(R0, t0, xw_p[src], obs, inv_sigma2_feat, has,
                        fx, fy, cx, cy, bf,
                        prior_w_rot=prior_w_rot, prior_w_trans=prior_w_trans)
    inl = res.inlier & has
    n_real = torch.sum(inl & real_p[src])
    return TrackStepResult(R=res.R, t=res.t,
                           point_of_feat=torch.where(inl, pof,
                                                     torch.full_like(pof, -1)),
                           n_matches=m.n_matches, n_real_inliers=n_real)


def local_map_step(xw_c, desc_c, valid_c, normal_c, maxd_c, mind_c,
                   exist_xw, exist_valid, exist_real,
                   R0, t0, ow,
                   feat_xy_un, feat_ur, feat_oct, feat_desc, feat_valid,
                   inv_sigma2_feat,
                   fx, fy, cx, cy, bf, width, height,
                   scale_factors, log_scale, n_levels, th,
                   prior_w_rot=0.0, prior_w_trans=0.0) -> TrackStepResult:
    """SearchLocalPoints + PoseOptimization (TrackLocalMap).

    exist_xw/exist_valid: the frame's current associations (by feature).
    point_of_feat holds new candidate matches (>= 0), -2 for an existing
    association that the pose LM rejected, -1 otherwise."""
    m = match_local_points(xw_c, desc_c, valid_c, normal_c, maxd_c, mind_c,
                           R0, t0, ow,
                           feat_xy_un, feat_ur, feat_oct, feat_desc,
                           feat_valid, exist_valid,
                           fx, fy, cx, cy, bf, width, height,
                           scale_factors, log_scale, n_levels, th)
    pof = m.point_of_feat
    cand_has = pof >= 0
    src = torch.clamp(pof, min=0)
    xw = torch.where(exist_valid[:, None], exist_xw, xw_c[src])
    valid = exist_valid | cand_has
    obs = torch.cat([feat_xy_un, feat_ur[:, None]], dim=1)
    res = pose_optimize(R0, t0, xw, obs, inv_sigma2_feat, valid,
                        fx, fy, cx, cy, bf,
                        prior_w_rot=prior_w_rot, prior_w_trans=prior_w_trans)
    inl = res.inlier & valid
    is_real = torch.where(exist_valid, exist_real, cand_has)
    n_real = torch.sum(inl & is_real)
    pof_out = torch.where(cand_has & inl, pof,
                          torch.where(exist_valid & ~inl,
                                      torch.full_like(pof, -2),
                                      torch.full_like(pof, -1)))
    return TrackStepResult(R=res.R, t=res.t, point_of_feat=pof_out,
                           n_matches=m.n_matches, n_real_inliers=n_real)


class FullTrackResult(NamedTuple):
    """The fused step's result on the host (numpy)."""
    feat_f32: np.ndarray   # [N, 8]: xy(2) xy_un(2) response angle u_right depth
    feat_i32: np.ndarray   # [N, 4]: octave valid motion_pof local_pof
    desc32: np.ndarray     # [N, 8] uint32
    scalars: np.ndarray    # [17]: R(9) t(3) n_motion n_inliers pad(3)


def _pack(feat_f32, feat_i32, desc32, scalars) -> torch.Tensor:
    """One int32 tensor holding every result leaf (float leaves as bit
    views), so the result crosses to the host in a single copy."""
    return torch.cat([feat_f32.contiguous().view(torch.int32).reshape(-1),
                      feat_i32.to(torch.int32).reshape(-1),
                      desc32.contiguous().reshape(-1),
                      scalars.contiguous().view(torch.int32)])


def _unpack(flat: np.ndarray, n: int) -> FullTrackResult:
    o1, o2, o3 = 8 * n, 12 * n, 20 * n
    return FullTrackResult(
        feat_f32=flat[:o1].view(np.float32).reshape(n, 8),
        feat_i32=flat[o1:o2].reshape(n, 4),
        desc32=flat[o2:o3].view(np.uint32).reshape(n, 8),
        scalars=flat[o3:].view(np.float32))


def make_full_track_step(frontend, config):
    """Build the per-frame tracking step.  The returned function takes the
    uint8 images and the packed host-built tables, all as device tensors,
    and returns a host FullTrackResult."""
    cam = config.camera
    fx, fy, cx, cy, bf = (float(cam.fx), float(cam.fy), float(cam.cx),
                          float(cam.cy), float(cam.bf))
    width, height = cam.width, cam.height
    orb = config.orb
    dev = frontend.device
    scale_factors = torch.tensor(
        [orb.scale_factor ** l for l in range(orb.n_levels)],
        dtype=torch.float32, device=dev)
    inv_sigma2 = 1.0 / (scale_factors ** 2)
    log_scale = float(np.log(orb.scale_factor))
    n_levels = orb.n_levels
    opt = config.optimizer
    pw_rot = 1.0 / opt.motion_prior_sigma_rot ** 2 \
        if opt.motion_prior_sigma_rot > 0 else 0.0
    pw_trans = 1.0 / opt.motion_prior_sigma_t ** 2 \
        if opt.motion_prior_sigma_t > 0 else 0.0

    def step(imL_u8, imR_u8,
             prior_pack,              # [12]: R(9) t(3)
             last_f32,                # [Np, 8]: xw(3) ang oct valid real pad
             desc_p,
             cand_f32,                # [Pc, 9]: xw(3) normal(3) maxd mind valid
             desc_c,
             forward: bool, backward: bool) -> FullTrackResult:
        R_prior = prior_pack[:9].reshape(3, 3)
        t_prior = prior_pack[9:12]
        xw_p = last_f32[:, 0:3]
        ang_p = last_f32[:, 3]
        oct_p = last_f32[:, 4].to(torch.int64)
        valid_p = last_f32[:, 5] > 0
        real_p = last_f32[:, 6] > 0
        xw_c = cand_f32[:, 0:3]
        normal_c = cand_f32[:, 3:6]
        maxd_c = cand_f32[:, 6]
        mind_c = cand_f32[:, 7]
        valid_c = cand_f32[:, 8] > 0

        fL, fR, sm, xy_un = frontend._build_impl(imL_u8, imR_u8)
        isig = inv_sigma2[fL.octave]

        def motion(th):
            return motion_model_step(
                xw_p, desc_p, oct_p, ang_p, valid_p, real_p,
                R_prior, t_prior,
                xy_un, sm.u_right, fL.octave, fL.angle, fL.desc32, fL.valid,
                isig, fx, fy, cx, cy, bf, width, height,
                scale_factors, th, forward, backward,
                prior_w_rot=pw_rot, prior_w_trans=pw_trans)

        m = motion(7.0)
        if int(m.n_matches) < 20:        # host sync 1: the x2-window retry
            m = motion(14.0)

        # existing associations for the local stage = motion inlier matches
        src = torch.clamp(m.point_of_feat, min=0)
        exist_valid = m.point_of_feat >= 0
        exist_xw = xw_p[src]
        exist_real = real_p[src] & exist_valid

        loc = local_map_step(
            xw_c, desc_c, valid_c, normal_c, maxd_c, mind_c,
            exist_xw, exist_valid, exist_real,
            m.R, m.t, -m.R.T @ m.t,
            xy_un, sm.u_right, fL.octave, fL.desc32, fL.valid, isig,
            fx, fy, cx, cy, bf, width, height,
            scale_factors, log_scale, n_levels, 1.0,
            prior_w_rot=pw_rot, prior_w_trans=pw_trans)

        feat_f32 = torch.cat([
            fL.xy, xy_un, fL.response[:, None], fL.angle[:, None],
            sm.u_right[:, None], sm.depth[:, None]], dim=1)
        feat_i32 = torch.stack([
            fL.octave, fL.valid.to(torch.int64),
            m.point_of_feat, loc.point_of_feat], dim=1)
        scalars = torch.cat([
            loc.R.reshape(-1), loc.t,
            m.n_matches.to(torch.float32)[None],
            loc.n_real_inliers.to(torch.float32)[None],
            torch.zeros(3, dtype=torch.float32, device=dev)])
        packed = _pack(feat_f32, feat_i32, fL.desc32, scalars)
        flat = packed.cpu().numpy()      # host sync 2: the one result copy
        return _unpack(flat, fL.xy.shape[0])

    return step
