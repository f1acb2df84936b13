"""Dynamic human-trajectory bundle adjustment — the AirDOS math core.

Behavioral rebuild of Optimizer::LocalBundleAdjustmentHumanTrajactory
(reference src/Optimizer.cc:1496-2224) as airdos_tpu/solvers/human_ba.py
runs it.  Vertices: local + fixed camera SE3s, static points, per-(pose,
part) human joint positions (14 body parts), per-(trajectory, part) limb
lengths, per-trajectory SE(3) constant-velocity motion.  Edge families:

- static stereo/mono projections (info = invSigma2), every landmark
  Schur-marginalised as in the local BA (``local_ba.schur_reduce``: three
  segment sums a step; back-substitution reads their Wagg);
- human-joint stereo projections from the pose's reference keyframe
  (info = SigmaHuman);
- ternary rigidity | ||pA - pB|| - d | (info = SigmaRigidity, Huber delta
  thRanSacRigidity);
- ternary constant-velocity motion p1 - H_dt^-1 p2 over consecutive poses
  x 5 torso joints (info = SigmaMotion, Huber delta thHuberMotion);
  motion updates are translation-only.

Protocol: phase 1 with Huber (when ``use_huber``) -> chi-square
deactivation (7.815 projections, thRanSacRigidity, thRanSacMotion) ->
phase 2 without robust kernels -> final inlier flags.

The cameras, joints, limb lengths and motions form one dense reduced
system.  The human families' J^T W J blocks land in it at positions that
repeat (a joint's diagonal block collects its projection edge, up to five
rigidity edges and two motion edges; a camera block collects every joint
projection it sees), so the scatter is one segment sum over the distinct
(row, col) positions of H and rows of b (``make_compact_segments``, built
once a call: the indices are fixed across the 15 steps).  Each sum runs
in edge order, bit-equal between the kernel and its plain version, with
no float atomics.  Four segment-sum launches a step, 60 a solve.  The LM
loop never reads a device value on the host.

The per-edge work is kernel launches on the card: the static edges'
rows, the static family's LM cost in ``ops/lm_cost``'s fixed order, and
the costs and depths of the chi-square passes (``ops/ba_static``), the
landmark reduction and back-substitution (``ops/ba_points``), and the
three human families' column of J^T W J and -J^T W e entries, their three
LM costs in that fixed order, and their costs and depths
(``ops/ba_human``, on the edge tables checked once a solve by
``launch_tables``).  A solve launches static_edge_blocks and
human_edge_blocks 34 times each (15 steps, 17 costs, 2 chi-square
passes), and landmark_reduce and landmark_backsub 15 each.
On the CPU every kernel's plain version runs, bit-equal to it.

Multi-device (airdos_tpu's ``axis_name``): given a mesh ``group``
(``parallel/mesh.py``) and shard-local STATIC edge tables (es_*), the
static edges' three segment sums and their cost term are psum-reduced
over the mesh, where airdos_tpu psums them; the human families, a few
thousand small edges, and the dense reduced solve run replicated on
every rank.  A rank so launches the same four segment sums a step (three
over its static shard, one over all the human edges): 60 a solve per
rank.  See ``parallel.sharded_ba.sharded_human_bundle_adjust``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from airdos_tpu_torch.geometry.se3 import se3_compose, se3_exp, so3_exp
from airdos_tpu_torch.ops.ba_human import (HumanTables, human_edge_blocks,
                                           human_edge_cost,
                                           human_edge_cost_sum,
                                           launch_tables)
from airdos_tpu_torch.ops.ba_static import (DELTA_STEREO, static_edge_blocks,
                                            static_edge_cost,
                                            static_edge_cost_sum)
from airdos_tpu_torch.ops.segment_kernels import (make_compact_segments,
                                                  segment_sum)
from airdos_tpu_torch.slam.map import BODY1, BODY2, MAIN_SKELETON, N_PARTS
from airdos_tpu_torch.solvers.local_ba import (CHI2_STEREO, _identity,
                                               back_substitute, schur_reduce,
                                               static_segments)
from airdos_tpu_torch.solvers.smallmat import cho_solve_dense


class HumanBAResult(NamedTuple):
    cam_R: torch.Tensor        # [C, 3, 3]
    cam_t: torch.Tensor        # [C, 3]
    points: torch.Tensor       # [P, 3]
    joints: torch.Tensor       # [T, L, 14, 3]
    seg_len: torch.Tensor      # [T, 14]
    mot_R: torch.Tensor        # [T, 3, 3]
    mot_t: torch.Tensor        # [T, 3]  (velocity per unit time)
    static_inlier: torch.Tensor   # [Es]
    key_inlier: torch.Tensor      # [T, L, 14] projection-edge inlier
    rigid_inlier: torch.Tensor    # [T, L, 14] per-pose segment inlier
    motion_inlier: torch.Tensor   # [T, L-1, 5]  (pose l -> l+1)


class HumanEdges(NamedTuple):
    """The three human families' edge tables (flattened), their validity
    and the indices of their entries in the dense system."""
    tables: HumanTables      # what ops/ba_human reads (int32 indices)
    hp_valid: torch.Tensor   # [Eh]
    rg_valid: torch.Tensor   # [Er]
    mo_valid: torch.Tensor   # [Em]
    gidx: tuple              # per family [E, q] coordinates in x


def human_edges(jo_cam, jo_obs, jo_valid, joint_exists, seg_edge_valid,
                traj_valid, pose_dt, motion_edge_valid, C: int) -> HumanEdges:
    """Edge tables of the human families (airdos_tpu human_ba.py:132-164)
    and their global coordinates in x = [cameras 6C | joints 3NJ | limb
    lengths 14T | motions 6T]."""
    dev = jo_obs.device
    T, L = jo_obs.shape[0], jo_obs.shape[1]
    NJ = T * L * N_PARTS
    off_j, off_d = 6 * C, 6 * C + 3 * NJ
    off_m = off_d + N_PARTS * T
    body1, body2, torso = (torch.as_tensor(a, dtype=torch.int64, device=dev)
                           for a in (BODY1, BODY2, MAIN_SKELETON))
    tt = torch.arange(T, device=dev)[:, None, None]
    ll = torch.arange(L, device=dev)[None, :, None]
    kk = torch.arange(N_PARTS, device=dev)[None, None, :]

    def jidx(t, l, k):
        return (t * L + l) * N_PARTS + k

    shape = (T, L, N_PARTS)
    jo_cam = jo_cam.to(torch.int64)
    hp_cam = jo_cam[:, :, None].expand(shape).reshape(-1)
    hp_joint = jidx(tt, ll, kk).expand(shape).reshape(-1)
    hp_valid = (jo_valid & joint_exists & (jo_cam[:, :, None] >= 0)).reshape(-1)
    hp_cam = torch.clamp(hp_cam, min=0)

    rg_j1 = jidx(tt, ll, body1[None, None, :]).expand(shape).reshape(-1)
    rg_j2 = jidx(tt, ll, body2[None, None, :]).expand(shape).reshape(-1)
    rg_seg = (tt * N_PARTS + kk).expand(shape).reshape(-1)
    rg_valid = (seg_edge_valid & joint_exists[:, :, body1]
                & joint_exists[:, :, body2]).reshape(-1)

    mshape = (T, L - 1, 5)
    lm = torch.arange(L - 1, device=dev)[None, :, None]
    mo_j1 = jidx(tt, lm, torso[None, None, :]).expand(mshape).reshape(-1)
    mo_j2 = jidx(tt, lm + 1, torso[None, None, :]).expand(mshape).reshape(-1)
    mo_traj = tt.expand(mshape).reshape(-1)
    mo_dt = pose_dt[:, :L - 1, None].expand(mshape).reshape(-1)
    je = joint_exists[:, :, torso]
    mo_valid = ((motion_edge_valid[:, :L - 1, :] & je[:, :L - 1] & je[:, 1:])
                & traj_valid[:, None, None]).reshape(-1)

    a3 = torch.arange(3, device=dev)[None, :]
    a6 = torch.arange(6, device=dev)[None, :]
    g_h = torch.cat([hp_cam[:, None] * 6 + a6,
                     off_j + hp_joint[:, None] * 3 + a3], dim=1)      # [E, 9]
    g_r = torch.cat([off_j + rg_j1[:, None] * 3 + a3,
                     off_j + rg_j2[:, None] * 3 + a3,
                     off_d + rg_seg[:, None]], dim=1)                  # [E, 7]
    g_m = torch.cat([off_j + mo_j1[:, None] * 3 + a3,
                     off_j + mo_j2[:, None] * 3 + a3,
                     off_m + mo_traj[:, None] * 6 + a6], dim=1)        # [E, 12]
    i32 = torch.int32
    tables = HumanTables(
        hp_cam=hp_cam.to(i32), hp_joint=hp_joint.to(i32),
        hp_obs=jo_obs.reshape(-1, 3).contiguous(), rg_j1=rg_j1.to(i32),
        rg_j2=rg_j2.to(i32), rg_seg=rg_seg.to(i32), mo_j1=mo_j1.to(i32),
        mo_j2=mo_j2.to(i32), mo_traj=mo_traj.to(i32),
        mo_dt=mo_dt.to(jo_obs.dtype).contiguous())
    return HumanEdges(tables=tables, hp_valid=hp_valid, rg_valid=rg_valid,
                      mo_valid=mo_valid, gidx=(g_h, g_r, g_m))


def scatter_keys(gidx, valid, D: int):
    """Flat keys of the families' entries, in the order ``scatter_values``
    lays them out: every family's J^T W J block at row * D + col of H, then
    every family's J^T W e at D * D + row.  Rows of invalid edges (zero in
    every step) are not kept."""
    keys, keep = [], []
    for g, v in zip(gidx, valid):
        q = g.shape[1]
        keys.append((g[:, :, None] * D + g[:, None, :]).reshape(-1))
        keep.append(v[:, None].expand(-1, q * q).reshape(-1))
    for g, v in zip(gidx, valid):
        keys.append((D * D + g).reshape(-1))
        keep.append(v[:, None].expand_as(g).reshape(-1))
    return torch.cat(keys), torch.cat(keep)


def scatter_values(blocks):
    """blocks: per family (Jl [E, r, q], w [E], el [E, r]) -> one column of
    the J^T W J and -J^T W e entries in ``scatter_keys``' order (the
    essential graph's; the human families' column is ops/ba_human's)."""
    hs, bs = [], []
    for Jl, w, el in blocks:
        hs.append(torch.einsum("erq,e,erp->eqp", Jl, w, Jl).reshape(-1))
        bs.append(-torch.einsum("erq,e,er->eq", Jl, w, el).reshape(-1))
    return torch.cat(hs + bs)[:, None]


def human_bundle_adjust(
        cam_R, cam_t, cam_fixed,                  # [C,...]
        points, point_valid,                      # [P, 3] static
        es_cam, es_pt, es_obs, es_info, es_valid,  # static edges [Es]
        joints,                                   # [T, L, 14, 3]
        joint_exists,                             # [T, L, 14] vertex exists
        jo_cam,                                   # [T, L] observing cam (-1 none)
        jo_obs,                                   # [T, L, 14, 3] (u, v, uR)
        jo_valid,                                 # [T, L, 14] has projection edge
        seg_len, seg_free, seg_edge_valid,        # [T,14],[T,14],[T,L,14]
        mot_R, mot_t, traj_valid,                 # [T,...]
        pose_dt,                                  # [T, L] dt from pose l to l+1
        motion_edge_valid,                        # [T, L, 5] pose l->l+1, torso
        sigma_static, sigma_human, sigma_rigidity, sigma_motion,
        th_huber_motion, th_ransac_motion, th_ransac_rigidity,
        fx, fy, cx, cy, bf,
        use_huber: bool = True,
        iters1: int = 5, iters2: int = 10, group=None) -> HumanBAResult:
    """group: a mesh rank's Group when the static edge arrays are its
    shard (the human arrays are whole on every rank)."""
    psum = _identity if group is None else group.psum
    dtype, dev = points.dtype, points.device
    C = cam_R.shape[0]
    P = points.shape[0]
    T, L = joints.shape[0], joints.shape[1]
    NJ = T * L * N_PARTS
    D = 6 * C + 3 * NJ + N_PARTS * T + 6 * T
    off_j, off_d = 6 * C, 6 * C + 3 * NJ
    off_m = off_d + N_PARTS * T
    cam = (fx, fy, cx, cy, bf)
    es_cam = es_cam.to(torch.int32)
    es_pt = es_pt.to(torch.int32)
    ed = human_edges(jo_cam, jo_obs, jo_valid, joint_exists, seg_edge_valid,
                     traj_valid, pose_dt, motion_edge_valid, C)
    tables = ed.tables
    if tables.hp_cam.is_cuda:             # checked for the kernel once
        tables = launch_tables(tables)
    Eh, Er = ed.hp_valid.shape[0], ed.rg_valid.shape[0]
    # the human keys use the stereo chi2 threshold's delta
    sig = (sigma_human, sigma_rigidity, sigma_motion, DELTA_STEREO,
           th_ransac_rigidity, th_huber_motion)

    # free mask over x; translation-only motion updates: the reference's
    # LandmarkMotionTernaryEdge Jacobian is zero wrt the rotation block
    # (g2o_dyn_slam3d.h:88-100)
    rot_dims = (torch.arange(6 * T, device=dev) % 6) >= 3
    free = torch.cat([(~cam_fixed).repeat_interleave(6),
                      joint_exists.reshape(-1).repeat_interleave(3),
                      seg_free.reshape(-1),
                      traj_valid.repeat_interleave(6) & ~rot_dims])
    freef = free.to(dtype)
    eye_d = torch.eye(D, dtype=dtype, device=dev)
    fixed_diag = torch.diag(1.0 - freef)

    # the sorted-segment indices, once per call: the static edges' three
    # reductions and the human families' scatter into H and b
    base_s = es_valid & point_valid[es_pt.long()]
    segs_s = static_segments(es_cam, es_pt, C, P, base_s)
    keys, keep = scatter_keys(ed.gidx, (ed.hp_valid, ed.rg_valid,
                                        ed.mo_valid), D)
    seg_h, pos_h = make_compact_segments(keys, keep)

    def human_costs(state, use_huber: bool):
        """The human edges' (rho, chi2, depth)."""
        camR, camt, pts, jnts, segs, mR, mt = state
        return human_edge_cost(camR, camt, jnts, segs, mR, mt, tables, cam,
                               sig, use_huber)

    def cost(state, act, use_huber: bool):
        camR, camt, pts, jnts, segs, mR, mt = state
        hs = human_edge_cost_sum(camR, camt, jnts, segs, mR, mt, tables,
                                 act[1:], cam, sig, use_huber)
        return ((psum(static_edge_cost_sum(camR, camt, pts, es_cam, es_pt,
                                           es_obs, es_info, act[0], cam,
                                           sigma_static, use_huber))
                 + hs[0]) + hs[1]) + hs[2]

    def gn_step(state, act, lam, use_huber: bool):
        camR, camt, pts, jnts, segs, mR, mt = state
        # static edges: Schur into the camera block
        rows = static_edge_blocks(camR, camt, pts, es_cam, es_pt, es_obs,
                                  es_info, act[0], cam, sigma_static,
                                  use_huber)
        schur = schur_reduce(rows, segs_s, point_valid, lam, C, P, psum)

        # human families: vars cam(6) + joint(3); j1(3) + j2(3) + limb(1);
        # j1(3) + j2(3) + motion(6)
        vals = human_edge_blocks(camR, camt, jnts, segs, mR, mt, tables,
                                 act[1:], cam, sig, use_huber)
        Hb = torch.zeros(D * D + D, dtype=dtype, device=dev)
        Hb[pos_h] = segment_sum(vals[:, None], seg_h)[:, 0]
        H = Hb[:D * D].reshape(D, D)
        b = Hb[D * D:]
        H[:6 * C, :6 * C] += schur.S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
        b[:6 * C] += schur.b.reshape(-1)

        # freeze + damp + solve
        H = H * freef[:, None] * freef[None, :] + fixed_diag
        b = b * freef
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-6 * eye_d
        dx = cho_solve_dense(Hd, b) * freef

        # apply updates
        dxc = dx[:6 * C].reshape(C, 6)
        dR, dt = se3_exp(dxc)
        camR2, camt2 = se3_compose(dR, dt, camR, camt)
        jnts2 = jnts + dx[off_j:off_d].reshape(T, L, N_PARTS, 3)
        segs2 = segs + dx[off_d:off_m].reshape(T, N_PARTS)
        dmot = dx[off_m:].reshape(T, 6)
        mt2 = mt + dmot[:, :3]
        mR2 = torch.matmul(mR, so3_exp(dmot[:, 3:]))
        pts2 = pts + back_substitute(schur, dxc, point_valid)
        return camR2, camt2, pts2, jnts2, segs2, mR2, mt2

    def run_phase(state, act, n_iters: int, use_huber: bool):
        lam = torch.tensor(1e-6, dtype=dtype, device=dev)
        f_prev = cost(state, act, use_huber)
        for _ in range(n_iters):
            new = gn_step(state, act, lam, use_huber)
            f_new = cost(new, act, use_huber)
            better = f_new < f_prev
            state = tuple(torch.where(better, n, o)
                          for n, o in zip(new, state))
            lam = torch.where(better, lam * 0.3, lam * 8.0)
            f_prev = torch.where(better, f_new, f_prev)
        return state

    def inliers(state):
        camR, camt, pts = state[:3]
        cs = static_edge_cost(camR, camt, pts, es_cam, es_pt, es_obs,
                              es_info, cam, sigma_static, False)
        ch = human_costs(state, False)
        chi_h, chi_r, chi_m = ch.chi2.split(
            [Eh, Er, ch.chi2.shape[0] - Eh - Er])
        return (base_s & (cs.chi2 <= CHI2_STEREO) & (cs.z > 0),
                ed.hp_valid & (chi_h <= CHI2_STEREO) & (ch.zh > 0),
                ed.rg_valid & (chi_r <= th_ransac_rigidity),
                ed.mo_valid & (chi_m <= th_ransac_motion))

    # Optimizer.IsHuber gates the phase-1 robust kernel (reference
    # Optimizer.cc:1599-1616)
    act1 = tuple(v.to(dtype) for v in (base_s, ed.hp_valid, ed.rg_valid,
                                       ed.mo_valid))
    state = (cam_R, cam_t, points, joints, seg_len, mot_R, mot_t)
    state = run_phase(state, act1, iters1, bool(use_huber))
    act2 = tuple(v.to(dtype) for v in inliers(state))
    state = run_phase(state, act2, iters2, False)
    s_in, h_in, r_in, m_in = inliers(state)

    camR, camt, pts, jnts, segs, mR, mt = state
    return HumanBAResult(
        cam_R=camR, cam_t=camt, points=pts, joints=jnts, seg_len=segs,
        mot_R=mR, mot_t=mt, static_inlier=s_in,
        key_inlier=h_in.reshape(T, L, N_PARTS),
        rigid_inlier=r_in.reshape(T, L, N_PARTS),
        motion_inlier=m_in.reshape(T, L - 1, 5))
