"""Sharded solvers over a device mesh: airdos_tpu/parallel/sharded_ba.py.

The same six paths, names and signatures, on ``parallel/mesh.py``'s
single-process mesh: each ``sharded_*`` factory takes a Mesh and returns
a function with the single-device solver's arguments and result.

- Edge-parallel bundle adjustment (pose step, local, human and global
  BA): every rank evaluates residuals and Jacobians and sums its shard of
  the edge table (its own ``segment_sum`` index: the kernel runs on every
  rank), the small block aggregates and the costs are psum-reduced over
  the mesh (rank order on rank 0, so runs are bit-equal), and the reduced
  solve and state update run replicated.  Edge tables must be padded to
  a multiple of the mesh size, padding rows invalid (``e_valid`` /
  ``es_valid`` False); they join no segment.  ``edge_inlier`` /
  ``static_inlier`` come back gathered to full length.
- Hypothesis-parallel RANSAC (EPnP, Sim3): the [H, k] sample table is
  sharded, every rank scores its hypotheses and keeps its first best,
  the champions (count, pose, inliers, index) are all-gathered in rank
  order, the first largest count wins, and the winner's refine runs
  replicated: the same winner, inliers and pose as the single-device
  ``epnp_ransac`` / ``sim3_ransac`` on the same table, whose argmax also
  keeps the first largest.  H must be a multiple of the mesh size.  On
  the card each rank's hypotheses are one launch of csrc/ransac.cu in
  hypotheses mode and the refine one launch in refine mode.

Per-rank ``segment_sum`` launches: 45 a local BA solve, 60 a human BA
solve (three over the static shard and one over the replicated human
families a step), 4 a global BA step, beside its CG's schur_point and
schur_camera in their raw mode, cg_iters each a step
(``global_ba.launches_per_step``).
"""
from __future__ import annotations

import torch

from airdos_tpu_torch.geometry.se3 import se3_compose, se3_exp, so3_hat
from airdos_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from airdos_tpu_torch.solvers.epnp import epnp_hypotheses, epnp_refine
from airdos_tpu_torch.solvers.global_ba import global_bundle_adjust
from airdos_tpu_torch.solvers.human_ba import human_bundle_adjust
from airdos_tpu_torch.solvers.local_ba import local_bundle_adjust
from airdos_tpu_torch.solvers.sim3 import sim3_hypotheses, sim3_refine


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")


def _stereo_system(R, t, xw, obs, w, fx, fy, cx, cy, bf):
    """Edge-shard H (6x6) and b (6) of the pose-only Gauss-Newton step."""
    xc = torch.einsum("ij,nj->ni", R, xw) + t
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / zs
    iz2 = iz * iz
    pred = torch.stack([fx * x * iz + cx, fy * y * iz + cy,
                        fx * x * iz + cx - bf * iz], dim=-1)
    e = obs - pred
    zero = torch.zeros_like(x)
    Jp = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1),
        torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1),
        torch.stack([fx * iz, zero, (-fx * x + bf) * iz2], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(
        xw.shape[0], 3, 3)
    Jxc = torch.cat([eye, -so3_hat(xc)], dim=-1)
    J = -torch.einsum("nij,njk->nik", Jp, Jxc)
    H = torch.einsum("nik,n,nij->kj", J, w, J)
    b = -torch.einsum("nik,n,ni->k", J, w, e)
    return H, b


def sharded_pose_optimize_step(mesh: Mesh, axis: str = "edges"):
    """A function (R, t, xw, obs, w, fx, fy, cx, cy, bf) -> (R', t'): one
    Gauss-Newton step with the edges sharded and the 6x6 system
    psum-reduced over the mesh."""
    _check_axis(mesh, axis)

    def step(R, t, xw, obs, w, fx, fy, cx, cy, bf):
        def shard_fn(group, R, t, xw_s, obs_s, w_s):
            H, b = _stereo_system(R, t, xw_s, obs_s, w_s, fx, fy, cx, cy, bf)
            H = group.psum(H)
            b = group.psum(b)
            eye = torch.eye(6, dtype=R.dtype, device=R.device)
            dx = torch.linalg.solve(H + 1e-6 * eye, b)
            dR, dt = se3_exp(dx)
            return se3_compose(dR, dt, R, t)

        return mesh.run(shard_fn, (R, t), (xw, obs, w))

    return step


def sharded_local_bundle_adjust(mesh: Mesh, axis: str = "edges",
                                iters1: int = 5, iters2: int = 10):
    """The full local-BA LM protocol (solvers.local_ba.local_bundle_adjust)
    with the edge table sharded over the mesh.  Returns a function with
    local_bundle_adjust's arguments and result."""
    _check_axis(mesh, axis)

    def run(cam_R, cam_t, cam_fixed, points, point_valid,
            e_cam, e_pt, e_obs, e_info, e_valid, fx, fy, cx, cy, bf):
        def shard_fn(group, *args):
            return local_bundle_adjust(*args, fx, fy, cx, cy, bf,
                                       iters1=iters1, iters2=iters2,
                                       group=group)

        return mesh.run(shard_fn,
                        (cam_R, cam_t, cam_fixed, points, point_valid),
                        (e_cam, e_pt, e_obs, e_info, e_valid),
                        sharded_out=("edge_inlier",))

    return run


def _champion(group, counts, packed, n_per_rank: int):
    """The first best of every rank's hypotheses, in one all-gather: each
    rank posts (count, local index, packed winner) as one float row;
    returns (the global winner's packed row, its global index)."""
    k = torch.argmax(counts)
    row = torch.cat([counts[k].to(packed.dtype)[None],
                     k.to(packed.dtype)[None], packed[k]])
    rows = group.all_gather(row)                       # [ranks, 2 + m]
    g = torch.argmax(rows[:, 0])
    best = g * n_per_rank + rows[g, 1].to(torch.int64)
    return rows[g, 2:], best


def sharded_epnp_ransac(mesh: Mesh, axis: str = "edges"):
    """Hypothesis-parallel EPnP RANSAC over the mesh.  Returns a function
    with epnp_ransac's arguments and result (``best`` indexes the whole
    sample table)."""
    _check_axis(mesh, axis)

    def run(pw, uv, valid, max_err2, sample_idx, fx, fy, cx, cy):
        n_per_rank = sample_idx.shape[0] // mesh.size

        def shard_fn(group, pw, uv, valid, max_err2, samples_s):
            Rs, ts, inls, counts = epnp_hypotheses(pw, uv, valid, max_err2,
                                                   samples_s, fx, fy, cx, cy)
            packed = torch.cat([Rs.reshape(-1, 9), ts,
                                inls.to(pw.dtype)], dim=1)
            win, best = _champion(group, counts, packed, n_per_rank)
            return epnp_refine(pw, uv, valid, max_err2,
                               win[:9].reshape(3, 3), win[9:12],
                               win[12:] > 0.5, best, fx, fy, cx, cy)

        return mesh.run(shard_fn, (pw, uv, valid, max_err2), (sample_idx,))

    return run


def sharded_sim3_ransac(mesh: Mesh, axis: str = "edges",
                        fix_scale: bool = True):
    """Hypothesis-parallel Sim3 RANSAC over the mesh (loop closure's
    ComputeSim3): the champion vote of sharded_epnp_ransac over Horn
    alignments.  Returns a function with sim3_ransac's arguments (but
    fix_scale, fixed here) and result."""
    _check_axis(mesh, axis)

    def run(x1, x2, valid, sample_idx, max_err1, max_err2, fx, fy, cx, cy):
        n_per_rank = sample_idx.shape[0] // mesh.size

        def shard_fn(group, x1, x2, valid, max_err1, max_err2, samples_s):
            Rs, ts, ss, inls, counts = sim3_hypotheses(
                x1, x2, valid, max_err1, max_err2, samples_s, fx, fy, cx, cy,
                fix_scale)
            packed = torch.cat([Rs.reshape(-1, 9), ts, ss[:, None],
                                inls.to(x1.dtype)], dim=1)
            win, best = _champion(group, counts, packed, n_per_rank)
            return sim3_refine(x1, x2, valid, max_err1, max_err2,
                               win[:9].reshape(3, 3), win[9:12], win[12],
                               win[13:] > 0.5, best, fx, fy, cx, cy,
                               fix_scale)

        return mesh.run(shard_fn, (x1, x2, valid, max_err1, max_err2),
                        (sample_idx,))

    return run


def sharded_human_bundle_adjust(mesh: Mesh, axis: str = "edges",
                                iters1: int = 5, iters2: int = 10):
    """The dynamic human-trajectory BA (solvers/human_ba.py) with the
    STATIC edge table sharded over the mesh and the human blocks
    replicated.  Returns a function with human_bundle_adjust's arguments
    and result."""
    _check_axis(mesh, axis)

    def run(cam_R, cam_t, cam_fixed, points, point_valid,
            es_cam, es_pt, es_obs, es_info, es_valid,
            joints, joint_exists, jo_cam, jo_obs, jo_valid,
            seg_len, seg_free, seg_edge_valid,
            mot_R, mot_t, traj_valid, pose_dt, motion_edge_valid,
            sigma_static, sigma_human, sigma_rigidity, sigma_motion,
            th_huber_motion, th_ransac_motion, th_ransac_rigidity,
            fx, fy, cx, cy, bf, use_huber=True):
        static = (cam_R, cam_t, cam_fixed, points, point_valid)
        human = (joints, joint_exists, jo_cam, jo_obs, jo_valid,
                 seg_len, seg_free, seg_edge_valid,
                 mot_R, mot_t, traj_valid, pose_dt, motion_edge_valid)
        scalars = (sigma_static, sigma_human, sigma_rigidity, sigma_motion,
                   th_huber_motion, th_ransac_motion, th_ransac_rigidity,
                   fx, fy, cx, cy, bf)

        def shard_fn(group, *args):
            rep = args[:len(static) + len(human)]
            edges = args[len(rep):]
            return human_bundle_adjust(
                *rep[:len(static)], *edges, *rep[len(static):], *scalars,
                use_huber=use_huber, iters1=iters1, iters2=iters2,
                group=group)

        return mesh.run(shard_fn, static + human,
                        (es_cam, es_pt, es_obs, es_info, es_valid),
                        sharded_out=("static_inlier",))

    return run


def sharded_global_bundle_adjust(mesh: Mesh, axis: str = "edges",
                                 iters1: int = 6, iters2: int = 10,
                                 cg_iters: int = 48):
    """Map-scale global BA (matrix-free Schur + PCG, solvers/global_ba.py)
    with the edge table sharded over the mesh.  Returns a function with
    global_bundle_adjust's arguments and result; its step_hook runs on
    rank 0 before every Gauss-Newton step, and the ranks wait for it."""
    _check_axis(mesh, axis)

    def run(cam_R, cam_t, cam_fixed, points, point_valid,
            e_cam, e_pt, e_obs, e_info, e_valid, fx, fy, cx, cy, bf,
            step_hook=None):
        def shard_fn(group, *args):
            return global_bundle_adjust(
                *args, fx, fy, cx, cy, bf, iters1=iters1, iters2=iters2,
                cg_iters=cg_iters, step_hook=step_hook, group=group)

        return mesh.run(shard_fn,
                        (cam_R, cam_t, cam_fixed, points, point_valid),
                        (e_cam, e_pt, e_obs, e_info, e_valid),
                        sharded_out=("edge_inlier",))

    return run
