"""Full-map bundle adjustment at map scale (matrix-free Schur + PCG).

Behavioral rebuild of Optimizer::GlobalBundleAdjustemnt (reference
src/Optimizer.cc:52-230) as airdos_tpu/solvers/global_ba.py computes it:
every keyframe (the first fixed) and every live map point, stereo/mono
projection edges, a Huber phase then a plain phase with chi-square-gated
outliers.

- The reduced camera system S = Hcc - W Hpp^-1 W^T is never formed: each
  (point, camera) pair has at most one edge, so W's blocks are the edge
  table and S x is two gathers and two segment sums.  The solve is
  conjugate gradients with the exact 6x6 block diagonal of S as its
  preconditioner.  Memory is O(E + P + C).
- Every sum over edges (airdos_tpu's ``.at[...].add``) is a deterministic
  ``segment_sum`` (``ops/segment_kernels``; a float ``index_add_`` on CUDA
  sums in a run-dependent order): per Gauss-Newton step one camera-keyed
  launch for Hcc | bc, one point-keyed for Hpp | bp, one camera-keyed for
  the reduced right-hand side's correction and the preconditioner's
  D_corr side by side, and one point-keyed for the back-substitution.
  The camera and point segment indices are built once per call.
- The CG is two launches an iteration (``ops/ba_global``): the point
  half ``schur_point`` walks the point-keyed index, the camera half
  ``schur_camera`` walks the camera-keyed one and runs the CG update
  across its grid.  Both are prepared once a step (``point_half``,
  ``camera_half``: the tensors checked once), so an iteration only
  launches.  Each walk reads Wcp in its own order, gathered once a step.
  Its dot products sum in one fixed order (``fixed_dot``; not XLA's
  order, so the packages agree within a tolerance, not bit for bit).
  ``launches_per_step(cg_iters)`` counts a step's launches.
- The loop never reads a device value on the host.
- Multi-device (airdos_tpu's ``axis_name``): given a mesh ``group``
  (``parallel/mesh.py``) and shard-local edge tables, every segment sum
  above and the LM costs are psum-reduced over the mesh, and the CG state
  stays replicated, so its dot products need no exchange.  The CG's two
  kernels run in their raw mode, which leaves the shard's sums before
  Hpp^-1 and before the update: each is psum-reduced, and Hpp^-1 and the
  update run eagerly on every rank as the kernels' plain versions
  (``ops.ba_global.matvec``, ``cg_update``: the single device's order).  Each
  shard's segment indices are its own: every rank launches
  ``launches_per_step(cg_iters)`` a step.  See
  ``parallel.sharded_ba.sharded_global_bundle_adjust``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from airdos_tpu_torch.geometry.se3 import se3_compose, se3_exp
from airdos_tpu_torch.ops.ba_global import (camera_half, cg_start, cg_update,
                                            make_walk, matvec, point_half,
                                            walk_rows)
from airdos_tpu_torch.ops.segment_kernels import make_segments, segment_sum
from airdos_tpu_torch.solvers.local_ba import (CHI2_MONO, CHI2_STEREO,
                                               _identity, _proj_residual)
from airdos_tpu_torch.solvers.smallmat import inv3x3, inv6x6


class GlobalBAResult(NamedTuple):
    R: torch.Tensor            # [C, 3, 3]
    t: torch.Tensor            # [C, 3]
    points: torch.Tensor       # [P, 3]
    edge_inlier: torch.Tensor  # [E] bool


def launches_per_step(cg_iters: int = 48) -> dict:
    """Each kernel's launches in one Gauss-Newton step."""
    return {"segment_sum": 4, "schur_point": cg_iters,
            "schur_camera": cg_iters}


def global_bundle_adjust(
        cam_R: torch.Tensor,       # [C, 3, 3] Tcw rotations
        cam_t: torch.Tensor,       # [C, 3]
        cam_fixed: torch.Tensor,   # [C] bool
        points: torch.Tensor,      # [P, 3]
        point_valid: torch.Tensor,  # [P] bool
        e_cam: torch.Tensor,       # [E] int
        e_pt: torch.Tensor,        # [E] int
        e_obs: torch.Tensor,       # [E, 3] (u, v, uR); uR < 0 -> mono
        e_info: torch.Tensor,      # [E] invSigma2
        e_valid: torch.Tensor,     # [E] bool
        fx, fy, cx, cy, bf,
        iters1: int = 6, iters2: int = 10,
        cg_iters: int = 48, step_hook=None, group=None) -> GlobalBAResult:
    """step_hook, when given, is called before each Gauss-Newton step (the
    online global BA waits there while tracking is in its frame); under a
    mesh rank 0 calls it and the ranks then meet at a barrier.  group: a
    mesh rank's Group when the edge arrays are its shard."""
    psum = _identity if group is None else group.psum
    C = cam_R.shape[0]
    P = points.shape[0]
    dtype, dev = points.dtype, points.device
    e_cam = e_cam.to(torch.int64)
    e_pt = e_pt.to(torch.int64)
    is_stereo = e_obs[:, 2] >= 0
    delta_h = torch.where(is_stereo, 2.795483, 2.447749).to(dtype)
    chi_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO).to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    cam_free = (~cam_fixed).to(dtype)[:, None]                # [C, 1]
    E = e_cam.shape[0]

    # the camera- and point-keyed segment indices, once a call; edges
    # outside `base` add exact zeros in every step and join no segment
    base = e_valid & point_valid[e_pt]
    seg_c = make_segments(e_cam, C, base)
    seg_p = make_segments(e_pt, P, base)
    walk_c = make_walk(seg_c, e_pt)       # the CG's walks of both indices
    walk_p = make_walk(seg_p, e_cam)
    free_c = cam_free[:, 0]

    def chi2_all(R, t, pts):
        e, _, _, z = _proj_residual(R[e_cam], t[e_cam], pts[e_pt], e_obs,
                                    fx, fy, cx, cy, bf, is_stereo)
        return torch.sum(e * e, dim=-1) * e_info, z

    def gn_step(R, t, pts, active, lam, use_huber: bool):
        e, Jc, Jp, _ = _proj_residual(R[e_cam], t[e_cam], pts[e_pt], e_obs,
                                      fx, fy, cx, cy, bf, is_stereo)
        chi2 = torch.sum(e * e, dim=-1) * e_info
        if use_huber:
            sq = torch.sqrt(torch.clamp(chi2, min=1e-12))
            w_h = torch.where(sq > delta_h, delta_h / sq, torch.ones_like(sq))
        else:
            w_h = torch.ones_like(chi2)
        w = e_info * w_h * active

        # --- O(E) normal-equation pieces -------------------------------
        cam_sums = psum(segment_sum(torch.cat(
            [torch.einsum("eik,e,eil->ekl", Jc, w, Jc).reshape(E, 36),
             -torch.einsum("eik,e,ei->ek", Jc, w, e)], dim=1), seg_c))
        pt_sums = psum(segment_sum(torch.cat(
            [torch.einsum("eik,e,eil->ekl", Jp, w, Jp).reshape(E, 9),
             -torch.einsum("eik,e,ei->ek", Jp, w, e)], dim=1), seg_p))
        Hcc, bc = cam_sums[:, :36].reshape(C, 6, 6), cam_sums[:, 36:]
        Hpp, bp = pt_sums[:, :9].reshape(P, 3, 3), pt_sums[:, 9:]
        Wcp = torch.einsum("eik,e,eil->ekl", Jc, w, Jp)        # [E, 6, 3]

        # damp + invert landmark blocks
        tr = Hpp.diagonal(dim1=1, dim2=2).sum(-1)
        Hpp_d = Hpp + (lam * eye3)[None] * \
            torch.clamp(tr[:, None, None] / 3.0, min=1e-3)
        Hpp_inv = inv3x3(Hpp_d + 1e-6 * eye3[None])
        Hpp_inv = torch.where(point_valid[:, None, None], Hpp_inv,
                              torch.zeros_like(Hpp_inv))

        # damped camera diagonal (Marquardt scaling on Hcc's diagonal)
        diag_scale = Hcc.diagonal(dim1=1, dim2=2)             # [C, 6]
        Hcc_d = Hcc + lam * torch.diag_embed(diag_scale) + 1e-6 * eye6[None]

        # the reduced rhs' correction W Hpp^-1 bp and the preconditioner's
        # D_corr = diag blocks of W Hpp^-1 W^T: both camera-keyed, one sum
        hb = torch.einsum("plm,pm->pl", Hpp_inv, bp)          # [P, 3]
        A_e = torch.einsum("ekl,elm->ekm", Wcp, Hpp_inv[e_pt])  # [E, 6, 3]
        corr = psum(segment_sum(torch.cat(
            [torch.einsum("ekl,el->ek", Wcp, hb[e_pt]),
             torch.einsum("ekm,elm->ekl", A_e, Wcp).reshape(E, 36)], dim=1),
            seg_c))
        b_red = (bc - corr[:, :6]) * cam_free
        D = Hcc_d - corr[:, 6:].reshape(C, 6, 6)
        D = D * cam_free[:, :, None] + eye6[None] * (1.0 - cam_free[:, :, None])
        D_inv = inv6x6(D + 1e-6 * eye6[None])

        # --- preconditioned CG on the reduced camera system ------------
        w_p, w_c = walk_rows(Wcp, walk_p), walk_rows(Wcp, walk_c)
        state = cg_start(b_red, D_inv)
        point = point_half(w_p, walk_p, state.p, free_c, Hpp_inv)
        camera = camera_half(w_c, walk_c, state, Hcc_d, D_inv, free_c, P)
        for _ in range(cg_iters):
            if group is None:
                camera(point())
            else:       # a mesh rank: the shard's sums, then psum
                z = matvec(Hpp_inv, psum(point(raw=True)))
                back = psum(camera(z, raw=True))
                cg_update(state, back, Hcc_d, D_inv, free_c)
        dx_c = state.x * cam_free

        # back-substitute points
        y = torch.einsum("ekl,ek->el", Wcp, dx_c[e_cam])
        WTdx = psum(segment_sum(y, seg_p))
        dx_p = torch.einsum("plm,pm->pl", Hpp_inv, bp - WTdx)
        dx_p = dx_p * point_valid[:, None].to(dtype)

        dR, dt = se3_exp(dx_c)
        Rn, tn = se3_compose(dR, dt, R, t)
        return Rn, tn, pts + dx_p

    def run_phase(R, t, pts, active, n_iters: int, use_huber: bool):
        def cost(R, t, pts):
            chi2, _ = chi2_all(R, t, pts)
            if use_huber:
                sq = torch.sqrt(torch.clamp(chi2, min=1e-12))
                rho = torch.where(sq > delta_h,
                                  2 * delta_h * sq - delta_h * delta_h, chi2)
            else:
                rho = chi2
            rho = torch.where(torch.isfinite(rho), rho,
                              torch.full_like(rho, 1e30))
            return psum(torch.sum(rho * active))

        lam = torch.tensor(1e-6, dtype=dtype, device=dev)
        f_prev = cost(R, t, pts)
        for _ in range(n_iters):
            if step_hook is not None:
                if group is None or group.rank == 0:
                    step_hook()
                if group is not None:
                    group.barrier()
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
    chi2, z = chi2_all(R, t, pts)
    inlier = base & (chi2 <= chi_th) & (z > 0)
    R, t, pts = run_phase(R, t, pts, inlier.to(dtype), iters2, False)
    chi2, z = chi2_all(R, t, pts)
    inlier = base & (chi2 <= chi_th) & (z > 0)
    return GlobalBAResult(R=R, t=t, points=pts, edge_inlier=inlier)
