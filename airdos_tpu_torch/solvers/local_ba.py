"""Local bundle adjustment with the Schur complement on the device.

Behavioral rebuild of Optimizer::LocalBundleAdjustment (reference
src/Optimizer.cc:431-731) as airdos_tpu/solvers/local_ba.py runs it:
local keyframes + their map points + fixed observer keyframes, stereo/mono
projection edges, 5 + 10 LM iterations with a chi-square outlier pass in
between (5.991 mono / 7.815 stereo), Huber kernel in the first phase.

- The graph is padded edge tables (camera index, point index, obs).
- Residuals and Jacobians of all edges at once.
- The Gauss-Newton blocks are summed per camera, per point and per
  (point, camera) pair with the deterministic segment sum of
  ``ops/segment_kernels`` (airdos_tpu's scatter-adds; a float
  ``index_add_`` on CUDA is order-nondeterministic).  The sorted-segment
  index is built once per call: the edge table is fixed across its 15
  steps.
- Every landmark 3x3 block is marginalised; the reduced camera system
  (6C x 6C) is solved densely by Cholesky.
- Each LM step is accepted or rejected with ``torch.where`` on the device:
  the loop never reads a device value on the host.

Multi-device sharding (airdos_tpu's ``axis_name`` / psum) is not ported
(ROADMAP port queue: multi-device).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from airdos_tpu_torch.geometry.se3 import se3_compose, se3_exp, so3_hat
from airdos_tpu_torch.ops.segment_kernels import make_segments, segment_sum
from airdos_tpu_torch.solvers.smallmat import cho_solve_dense, inv3x3

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
        iters1: int = 5, iters2: int = 10) -> LocalBAResult:
    C = cam_R.shape[0]
    P = points.shape[0]
    E = e_obs.shape[0]
    dtype, dev = points.dtype, points.device
    e_cam = e_cam.to(torch.int64)
    e_pt = e_pt.to(torch.int64)
    is_stereo = e_obs[:, 2] >= 0
    delta_h = torch.where(is_stereo, 2.795483, 2.447749).to(dtype)
    chi_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO).to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    diag_c = torch.arange(C, device=dev)

    # the sorted-segment index of each reduction, once per call.  Edges
    # outside `base` (padding, invalid points) have weight 0 in every step
    # and add exact zeros, so they join no segment: all padding would
    # otherwise key to camera 0 and point 0 and make those segments long.
    base = e_valid & point_valid[e_pt]
    seg_cam = make_segments(e_cam, C, base)
    seg_pt = make_segments(e_pt, P, base)
    seg_pc = make_segments(e_pt * C + e_cam, P * C, base)

    cam_free = (~cam_fixed).to(dtype)
    free_mask = cam_free[:, None, None, None] * cam_free[None, :, None, None]
    fixed_diag = (1.0 - cam_free)[:, None, None] * eye6[None]
    pv = point_valid[:, None].to(dtype)

    def chi2_all(R, t, pts):
        e, _, _, z = _proj_residual(R[e_cam], t[e_cam], pts[e_pt], e_obs,
                                    fx, fy, cx, cy, bf, is_stereo)
        return torch.sum(e * e, dim=-1) * e_info, z

    def gn_step(R, t, pts, active, lam, use_huber: bool):
        Rc = R[e_cam]
        e, Jc, Jp, _ = _proj_residual(Rc, t[e_cam], pts[e_pt], e_obs,
                                      fx, fy, cx, cy, bf, is_stereo)
        chi2 = torch.sum(e * e, dim=-1) * e_info
        if use_huber:
            sq = torch.sqrt(torch.clamp(chi2, min=1e-12))
            w_h = torch.where(sq > delta_h, delta_h / sq, torch.ones_like(sq))
        else:
            w_h = torch.ones_like(chi2)
        w = e_info * w_h * active

        # --- assemble blocks via the five segment sums ------------------
        Hcc = segment_sum(torch.einsum("eik,e,eil->ekl", Jc, w, Jc)
                          .reshape(E, 36), seg_cam).reshape(C, 6, 6)
        Hpp = segment_sum(torch.einsum("eik,e,eil->ekl", Jp, w, Jp)
                          .reshape(E, 9), seg_pt).reshape(P, 3, 3)
        bc = segment_sum(-torch.einsum("eik,e,ei->ek", Jc, w, e), seg_cam)
        bp = segment_sum(-torch.einsum("eik,e,ei->ek", Jp, w, e), seg_pt)
        # per-edge camera-point coupling W = Jc^T w Jp  [E, 6, 3]
        Wcp = torch.einsum("eik,e,eil->ekl", Jc, w, Jp)

        # damp + invert landmark blocks
        tr = Hpp.diagonal(dim1=1, dim2=2).sum(-1)
        Hpp = Hpp + (lam * eye3)[None] * \
            torch.clamp(tr[:, None, None] / 3.0, min=1e-3)
        Hpp = Hpp + 1e-6 * eye3[None]
        Hpp_inv = inv3x3(Hpp)
        Hpp_inv = torch.where(point_valid[:, None, None], Hpp_inv,
                              torch.zeros_like(Hpp_inv))

        # Schur: S = Hcc - sum_p (sum_{e in p, cam ci} W_e Hpp^-1)
        #                        (sum_{e' in p, cam cj} W_e')^T
        Wagg = segment_sum(Wcp.reshape(E, 18), seg_pc).reshape(P, C, 6, 3)
        Aagg = torch.einsum("pckl,plm->pckm", Wagg, Hpp_inv)
        S_corr = torch.einsum("pikm,pjlm->ijkl", Aagg, Wagg)   # [C, C, 6, 6]
        S = torch.zeros((C, C, 6, 6), dtype=dtype, device=dev)
        S[diag_c, diag_c] = Hcc
        S = S - S_corr
        b_corr = torch.einsum("pckm,pm->ck", Aagg, bp)
        b_red = bc - b_corr

        # freeze fixed cameras: identity rows/cols, zero rhs
        S = S * free_mask
        S[diag_c, diag_c] = S[diag_c, diag_c] + fixed_diag
        b_red = b_red * cam_free[:, None]

        # dense solve on the reduced system
        Sd = S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)
        Sd = Sd + lam * torch.diag(torch.diagonal(Sd)) + \
            1e-6 * torch.eye(6 * C, dtype=dtype, device=dev)
        dx_c = cho_solve_dense(Sd, b_red.reshape(-1)).reshape(C, 6)
        dx_c = dx_c * cam_free[:, None]

        # back-substitute points: dx_p = Hpp^-1 (bp - sum_c Wagg_pc^T dx_c)
        WTdx = torch.einsum("pckl,ck->pl", Wagg, dx_c)
        dx_p = torch.einsum("plm,pm->pl", Hpp_inv, bp - WTdx) * pv

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
            return torch.sum(rho * active)

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
    chi2, z = chi2_all(R, t, pts)
    inlier = base & (chi2 <= chi_th) & (z > 0)
    R, t, pts = run_phase(R, t, pts, inlier.to(dtype), iters2, False)
    chi2, z = chi2_all(R, t, pts)
    inlier = base & (chi2 <= chi_th) & (z > 0)
    return LocalBAResult(R=R, t=t, points=pts, edge_inlier=inlier)
