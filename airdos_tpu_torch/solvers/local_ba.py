"""Local bundle adjustment with the Schur complement on the device.

Behavioral rebuild of Optimizer::LocalBundleAdjustment (reference
src/Optimizer.cc:431-731) as airdos_tpu/solvers/local_ba.py runs it:
local keyframes + their map points + fixed observer keyframes, stereo/mono
projection edges, 5 + 10 LM iterations with a chi-square outlier pass in
between (5.991 mono / 7.815 stereo), Huber kernel in the first phase.

- The graph is padded edge tables (camera index, point index, obs).
- Residuals, Jacobians, weights and the Gauss-Newton rows of all edges at
  once: ``ops/ba_static``, one kernel launch a step on the card.
- The Gauss-Newton blocks are summed per camera, per point and per
  (point, camera) pair with the deterministic segment sum of
  ``ops/segment_kernels`` (airdos_tpu's scatter-adds; a float
  ``index_add_`` on CUDA is order-nondeterministic): three launches a
  step, 45 a solve.  The sorted-segment index is built once per call: the
  edge table is fixed across its 15 steps.
- Every landmark 3x3 block is marginalised (``ops/ba_points``: the damped
  inverses and Wagg Hpp^-1 in one launch, the back-substitution in
  another); the reduced camera system (6C x 6C) is solved densely by
  Cholesky.
- Each LM cost is one ``ops/ba_static`` launch in cost-sum mode, which
  sums the edges' robust costs in ``ops/lm_cost``'s fixed order in the
  same launch: 17 a solve, and one launch of the edges in cost mode for
  each of the two chi-square passes.  A solve so launches
  static_edge_blocks 34 times (15 steps, 17 costs, 2 passes), and
  landmark_reduce and landmark_backsub 15 each.  On the CPU every
  kernel's plain version runs, bit-equal to it.
- Each LM step is accepted or rejected with ``torch.where`` on the device:
  the loop never reads a device value on the host.
- Multi-device (airdos_tpu's ``axis_name``): given a mesh ``group``
  (``parallel/mesh.py``) and shard-local edge tables, the three segment
  sums and the LM costs are psum-reduced over the mesh, where airdos_tpu
  psums its scatter-adds and costs; the reduced solve and the landmark
  back-substitution run replicated.  Each shard's segment index is its
  own, so a sharded solve launches 45 segment sums on every rank.  See
  ``parallel.sharded_ba.sharded_local_bundle_adjust``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from airdos_tpu_torch.geometry.se3 import se3_compose, se3_exp, so3_hat
from airdos_tpu_torch.ops.ba_points import landmark_backsub, landmark_reduce
from airdos_tpu_torch.ops.ba_static import (StaticRows, static_edge_blocks,
                                            static_edge_cost,
                                            static_edge_cost_sum)
from airdos_tpu_torch.ops.segment_kernels import (Segments, make_segments,
                                                  segment_sum)
from airdos_tpu_torch.solvers.smallmat import cho_solve_dense

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class LocalBAResult(NamedTuple):
    R: torch.Tensor            # [C, 3, 3] optimized camera rotations
    t: torch.Tensor            # [C, 3]
    points: torch.Tensor       # [P, 3] optimized landmark positions
    edge_inlier: torch.Tensor  # [E] bool final classification


def _proj_residual(Rc, tc, xw, obs, fx, fy, cx, cy, bf, is_stereo):
    """Per-edge residual + Jacobians.  Rc [E,3,3], tc [E,3], xw [E,3].
    Returns e [E,3], Jc [E,3,6] (camera), Jp [E,3,3] (point), z [E].
    Mono edges (is_stereo False) have a zero third row."""
    xc = torch.einsum("eij,ej->ei", Rc, xw) + tc
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / zs
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    ur = u - bf * iz
    pred = torch.stack([u, v, ur], dim=-1)
    E = xw.shape[0]
    keep = torch.ones((E, 3), dtype=torch.bool, device=xw.device)
    keep[:, 2] = is_stereo
    e = torch.where(keep, obs - pred, torch.zeros_like(pred))

    zero = torch.zeros_like(x)
    Jproj = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1),
        torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1),
        torch.stack([fx * iz, zero, (-fx * x + bf) * iz2], dim=-1),
    ], dim=-2)                                              # [E, 3, 3]
    Jproj = torch.where(keep[:, :, None], Jproj, torch.zeros_like(Jproj))
    eye = torch.eye(3, dtype=xw.dtype, device=xw.device).expand(E, 3, 3)
    Jxc_cam = torch.cat([eye, -so3_hat(xc)], dim=-1)        # [E, 3, 6]
    Jc = -torch.einsum("eij,ejk->eik", Jproj, Jxc_cam)
    Jp = -torch.einsum("eij,ejk->eik", Jproj, Rc)           # d e / d xw
    return e, Jc, Jp, z


class StaticSegments(NamedTuple):
    """The sorted-segment indices of the static edges' three reductions,
    made once per solve (the edge table is fixed across its steps)."""
    cam: Segments           # by camera
    pt: Segments            # by point
    pc: Segments            # by (point, camera)


def static_segments(e_cam, e_pt, C: int, P: int,
                    base: torch.Tensor) -> StaticSegments:
    """Edges outside `base` (padding, invalid points) have weight 0 in
    every step and add exact zeros, so they join no segment: all padding
    would otherwise key to camera 0 and point 0 and make those segments
    long."""
    return StaticSegments(cam=make_segments(e_cam, C, base),
                          pt=make_segments(e_pt, P, base),
                          pc=make_segments(e_pt * C + e_cam, P * C, base))


class SchurBlocks(NamedTuple):
    S: torch.Tensor         # [C, C, 6, 6] reduced camera system
    b: torch.Tensor         # [C, 6] its right-hand side
    Hpp_inv: torch.Tensor   # [P, 3, 3] damped landmark blocks, inverted
    pt_sums: torch.Tensor   # [P, 12] Hpp (9) | bp (3)
    Wagg: torch.Tensor      # [P, C * 18] camera-point coupling per pair


def _identity(x):
    return x


def schur_reduce(rows: StaticRows, segs: StaticSegments, point_valid, lam,
                 C: int, P: int, psum=_identity) -> SchurBlocks:
    """The projection edges' Gauss-Newton blocks, every landmark
    marginalised: three segment sums of the edges' rows (airdos_tpu's five
    scatter-adds; the blocks that share a key sum side by side, each
    column in its own order, so the bits are those of separate sums), each
    psum-reduced over the mesh when the edges are a shard, then the
    landmark reduction."""
    cam_sums = psum(segment_sum(rows.cam, segs.cam))
    pt_sums = psum(segment_sum(rows.pt, segs.pt))
    Wagg = psum(segment_sum(rows.pc, segs.pc)).reshape(P, C * 18)
    Hcc, bc = cam_sums[:, :36].reshape(C, 6, 6), cam_sums[:, 36:]
    Hpp_inv, Aagg = landmark_reduce(pt_sums, Wagg, point_valid, lam)

    # Schur: S = Hcc - sum_p (sum_{e in p, cam ci} W_e Hpp^-1)
    #                        (sum_{e' in p, cam cj} W_e')^T
    W = Wagg.reshape(P, C, 6, 3)
    S_corr = torch.einsum("pikm,pjlm->ijkl", Aagg, W)      # [C, C, 6, 6]
    diag_c = torch.arange(C, device=W.device)
    S = torch.zeros((C, C, 6, 6), dtype=W.dtype, device=W.device)
    S[diag_c, diag_c] = Hcc
    S = S - S_corr
    b_corr = torch.einsum("pckm,pm->ck", Aagg, pt_sums[:, 9:])
    return SchurBlocks(S=S, b=bc - b_corr, Hpp_inv=Hpp_inv, pt_sums=pt_sums,
                       Wagg=Wagg)


def back_substitute(blocks: SchurBlocks, dx_c, point_valid) -> torch.Tensor:
    """The landmarks' steps: dx_p = Hpp^-1 (bp - sum_c Wagg_pc^T dx_c),
    zero where point_valid [P] is False."""
    return landmark_backsub(blocks.Hpp_inv, blocks.pt_sums, blocks.Wagg,
                            dx_c, point_valid)


def local_bundle_adjust(
        cam_R: torch.Tensor,        # [C, 3, 3] Tcw rotations (local + fixed)
        cam_t: torch.Tensor,        # [C, 3]
        cam_fixed: torch.Tensor,    # [C] bool — fixed observers
        points: torch.Tensor,       # [P, 3] world points
        point_valid: torch.Tensor,  # [P] bool
        e_cam: torch.Tensor,        # [E] int camera index per edge
        e_pt: torch.Tensor,         # [E] int point index per edge
        e_obs: torch.Tensor,        # [E, 3] (u, v, uR); uR < 0 -> mono
        e_info: torch.Tensor,       # [E] invSigma2
        e_valid: torch.Tensor,      # [E] bool
        fx, fy, cx, cy, bf,
        iters1: int = 5, iters2: int = 10, group=None) -> LocalBAResult:
    """group: a mesh rank's Group when the edge arrays are its shard
    (None: the whole table on one device)."""
    psum = _identity if group is None else group.psum
    C = cam_R.shape[0]
    P = points.shape[0]
    dtype, dev = points.dtype, points.device
    cam = (fx, fy, cx, cy, bf)
    e_cam = e_cam.to(torch.int32)
    e_pt = e_pt.to(torch.int32)
    chi_th = torch.where(e_obs[:, 2] >= 0, CHI2_STEREO, CHI2_MONO).to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    diag_c = torch.arange(C, device=dev)

    # the sorted-segment index of each reduction, once per call
    base = e_valid & point_valid[e_pt.long()]
    segs = static_segments(e_cam, e_pt, C, P, base)

    cam_free = (~cam_fixed).to(dtype)
    free_mask = cam_free[:, None, None, None] * cam_free[None, :, None, None]
    fixed_diag = (1.0 - cam_free)[:, None, None] * eye6[None]

    def edge_cost(R, t, pts, use_huber: bool):
        return static_edge_cost(R, t, pts, e_cam, e_pt, e_obs, e_info, cam,
                                1.0, use_huber)

    def gn_step(R, t, pts, active, lam, use_huber: bool):
        rows = static_edge_blocks(R, t, pts, e_cam, e_pt, e_obs, e_info,
                                  active, cam, 1.0, use_huber)
        blocks = schur_reduce(rows, segs, point_valid, lam, C, P, psum)

        # freeze fixed cameras: identity rows/cols, zero rhs
        S = blocks.S * free_mask
        S[diag_c, diag_c] = S[diag_c, diag_c] + fixed_diag
        b_red = blocks.b * cam_free[:, None]

        # dense solve on the reduced system
        Sd = S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
        Sd = Sd + lam * torch.diag(torch.diagonal(Sd)) + \
            1e-6 * torch.eye(6 * C, dtype=dtype, device=dev)
        dx_c = cho_solve_dense(Sd, b_red.reshape(-1)).reshape(C, 6)
        dx_c = dx_c * cam_free[:, None]

        dR, dt = se3_exp(dx_c)
        Rn, tn = se3_compose(dR, dt, R, t)
        return Rn, tn, pts + back_substitute(blocks, dx_c, point_valid)

    def run_phase(R, t, pts, active, n_iters: int, use_huber: bool):
        def cost(R, t, pts):
            return psum(static_edge_cost_sum(R, t, pts, e_cam, e_pt, e_obs,
                                             e_info, active, cam, 1.0,
                                             use_huber))

        lam = torch.tensor(1e-6, dtype=dtype, device=dev)
        f_prev = cost(R, t, pts)
        for _ in range(n_iters):
            Rn, tn, pn = gn_step(R, t, pts, active, lam, use_huber)
            f_new = cost(Rn, tn, pn)
            better = f_new < f_prev
            R = torch.where(better, Rn, R)
            t = torch.where(better, tn, t)
            pts = torch.where(better, pn, pts)
            lam = torch.where(better, lam * 0.3, lam * 8.0)
            f_prev = torch.where(better, f_new, f_prev)
        return R, t, pts

    R, t, pts = run_phase(cam_R, cam_t, points, base.to(dtype), iters1, True)
    _, chi2, z = edge_cost(R, t, pts, False)
    inlier = base & (chi2 <= chi_th) & (z > 0)
    R, t, pts = run_phase(R, t, pts, inlier.to(dtype), iters2, False)
    _, chi2, z = edge_cost(R, t, pts, False)
    inlier = base & (chi2 <= chi_th) & (z > 0)
    return LocalBAResult(R=R, t=t, points=pts, edge_inlier=inlier)
