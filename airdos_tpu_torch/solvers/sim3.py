"""Sim3 / SE3 solvers for loop closing, as airdos_tpu/solvers/sim3.py
computes them:

- ``sim3_ransac``: Horn closed form on 3-point samples with mutual
  reprojection chi-square inlier gates (reference Sim3Solver,
  src/Sim3Solver.cc; scale fixed for stereo).  The hypotheses are one
  leading batch dimension (batched Horn, one batched ``eigh``).
- ``optimize_sim3``: Gauss-Newton on the KF-pair Sim3 with mutual
  projection edges and an inlier re-check (Optimizer::OptimizeSim3,
  src/Optimizer.cc:2474-2660).  airdos_tpu builds its 7x7 system from
  ``jax.jacfwd``; here the Jacobians are closed forms of the same
  parametrization (R = exp(w) R0, t = t0 + u, s = s0 e^sigma).  They
  agree with torch.func.jacfwd's to float32 rounding; jacfwd took
  seconds on its first call on the card.  With a fixed scale the scale
  row and column are pinned to the identity.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from airdos_tpu_torch.geometry.se3 import _so3_left_jacobian, so3_exp, \
    so3_hat
from airdos_tpu_torch.solvers.align import horn_align


class Sim3RansacResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    best: torch.Tensor        # index of the best hypothesis


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def sim3_inlier_test(x1, x2, valid, max_err1, max_err2, fx, fy, cx, cy):
    """The mutual reprojection chi-square test of a Sim3 RANSAC: a function
    (R [H, 3, 3], t [H, 3], s [H]) -> inlier mask [H, n] (x2 into camera 1
    through S12, x1 into camera 2 through S21)."""
    z1o = _safe_z(x1[:, 2])
    uv1 = torch.stack([fx * x1[:, 0] / z1o + cx, fy * x1[:, 1] / z1o + cy], -1)
    z2o = _safe_z(x2[:, 2])
    uv2 = torch.stack([fx * x2[:, 0] / z2o + cx, fy * x2[:, 1] / z2o + cy], -1)

    def reproj_inliers(R, t, s):
        p1 = s[:, None, None] * torch.einsum("nj,hij->hni", x2, R) + \
            t[:, None, :]
        z1 = _safe_z(p1[..., 2])
        e1 = (fx * p1[..., 0] / z1 + cx - uv1[:, 0]) ** 2 + \
            (fy * p1[..., 1] / z1 + cy - uv1[:, 1]) ** 2
        p2 = (1.0 / s)[:, None, None] * torch.einsum(
            "hnj,hji->hni", x1[None] - t[:, None, :], R)
        z2 = _safe_z(p2[..., 2])
        e2 = (fx * p2[..., 0] / z2 + cx - uv2[:, 0]) ** 2 + \
            (fy * p2[..., 1] / z2 + cy - uv2[:, 1]) ** 2
        return valid & (e1 < max_err1) & (e2 < max_err2)
    return reproj_inliers


def sim3_refine(x1, x2, reproj_inliers, R_b, t_b, s_b, inl_b, best,
                fix_scale: bool = True) -> Sim3RansacResult:
    """Horn over the best hypothesis's inliers, kept when it has at least
    as many inliers as the hypothesis."""
    w = inl_b.to(x1.dtype) + 1e-6
    R_r, t_r, s_r = horn_align(x1, x2, weights=w, fix_scale=fix_scale)
    inl_r = reproj_inliers(R_r[None], t_r[None], s_r[None])[0]
    better = torch.sum(inl_r) >= torch.sum(inl_b)
    inl_f = torch.where(better, inl_r, inl_b)
    return Sim3RansacResult(R=torch.where(better, R_r, R_b),
                            t=torch.where(better, t_r, t_b),
                            s=torch.where(better, s_r, s_b),
                            inliers=inl_f, n_inliers=torch.sum(inl_f),
                            best=best)


def sim3_ransac(x1, x2, valid,            # [n, 3] camera-frame points, both KFs
                sample_idx,               # [H, 3]
                max_err1, max_err2,       # [n] chi2 gates (9.210 * sigma2)
                fx, fy, cx, cy,
                fix_scale: bool = True) -> Sim3RansacResult:
    """S12 (x1 ~ S12 x2) by RANSAC over 3-point Horn alignments with mutual
    reprojection checks."""
    reproj_inliers = sim3_inlier_test(x1, x2, valid, max_err1, max_err2,
                                      fx, fy, cx, cy)
    idx = sample_idx.to(torch.int64)
    Rs, ts, ss = horn_align(x1[idx], x2[idx], fix_scale=fix_scale)
    inls = reproj_inliers(Rs, ts, ss)
    best = torch.argmax(torch.sum(inls, dim=-1))
    return sim3_refine(x1, x2, reproj_inliers, Rs[best], ts[best], ss[best],
                       inls[best], best, fix_scale)


def optimize_sim3(R0, t0, s0,
                  x1, obs1, sig1,         # points in cam1 + their obs in cam1
                  x2, obs2, sig2,         # points in cam2 + their obs in cam2
                  valid,
                  fx, fy, cx, cy,
                  th2: float = 10.0, fix_scale: bool = True,
                  n_iters: int = 10):
    """GN on the 7-DoF (6 with a fixed scale) S12 with mutual projection
    residuals: S12 x2 against obs1 and S12^-1 x1 against obs2.  Returns
    (R, t, s, inlier mask, inlier count)."""
    dtype, dev = x1.dtype, x1.device
    s0 = torch.as_tensor(s0, dtype=dtype, device=dev)

    def project(p, obs, want_jac):
        """obs - pi(p) and, with want_jac, its Jacobian d/dp [n, 2, 3]."""
        z = _safe_z(p[:, 2])
        r = obs - torch.stack([fx * p[:, 0] / z + cx,
                               fy * p[:, 1] / z + cy], dim=1)
        if not want_jac:
            return r, None
        iz = 1.0 / z
        g = (torch.abs(p[:, 2]) >= 1e-9).to(dtype)    # the guard's slope
        zero = torch.zeros_like(iz)
        return r, -torch.stack([
            torch.stack([fx * iz, zero, -fx * p[:, 0] * iz * iz * g], -1),
            torch.stack([zero, fy * iz, -fy * p[:, 1] * iz * iz * g], -1),
        ], dim=1)

    def residuals(params, want_jac=False):
        """Both residual families [n, 2] and, with want_jac, their
        Jacobians [n, 2, 7] with respect to (w, u, sigma)."""
        w, u, sigma = params[:3], params[3:6], params[6]
        R = so3_exp(w) @ R0
        s = s0 * torch.exp(sigma)
        t = t0 + u
        Rx2 = x2 @ R.T
        p1 = s * Rx2 + t
        v = x1 - t
        p2 = (v @ R) / s
        r1, P1 = project(p1, obs1, want_jac)
        r2, P2 = project(p2, obs2, want_jac)
        if not want_jac:
            return r1, r2
        n = x1.shape[0]
        eye = torch.eye(3, dtype=dtype, device=dev).expand(n, 3, 3)
        # d(exp(w) y)/dw = -[exp(w) y]x J_l(w); exp(w)^T = exp(-w)
        Jl, Jl_neg = _so3_left_jacobian(w), _so3_left_jacobian(-w)
        D1 = torch.cat([-s * so3_hat(Rx2) @ Jl, eye, (s * Rx2)[:, :, None]],
                       dim=2)                                   # [n, 3, 7]
        D2 = torch.cat([R0.T @ so3_hat(v @ so3_exp(w)) @ Jl_neg / s,
                        -R.T.expand(n, 3, 3) / s, -p2[:, :, None]], dim=2)
        return r1, r2, P1 @ D1, P2 @ D2

    def chi2(params):
        r1, r2 = residuals(params)
        return torch.sum(r1 * r1, dim=1) / sig1, torch.sum(r2 * r2, dim=1) / sig2

    def cost(params, act):
        c1, c2 = chi2(params)
        return torch.sum((torch.clamp(c1, max=2 * th2) +
                          torch.clamp(c2, max=2 * th2)) * act)

    eye7 = torch.eye(7, dtype=dtype, device=dev)

    def gn(p, act, iters):
        lam = torch.tensor(1e-4, dtype=dtype, device=dev)
        f_prev = cost(p, act)
        w1 = torch.repeat_interleave(act / sig1, 2)
        w2 = torch.repeat_interleave(act / sig2, 2)
        for _ in range(iters):
            r1, r2, J1, J2 = residuals(p, want_jac=True)
            J1, J2 = J1.reshape(-1, 7), J2.reshape(-1, 7)
            H = (J1 * w1[:, None]).T @ J1 + (J2 * w2[:, None]).T @ J2
            g = -(J1 * w1[:, None]).T @ r1.reshape(-1) - \
                (J2 * w2[:, None]).T @ r2.reshape(-1)
            if fix_scale:
                H = H.clone()
                H[6, :] = 0.0
                H[:, 6] = 0.0
                H[6, 6] = 1.0
                g = g.clone()
                g[6] = 0.0
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-6 * eye7
            pn = p + torch.linalg.solve(Hd, g)
            f_new = cost(pn, act)
            better = f_new < f_prev
            p = torch.where(better, pn, p)
            lam = torch.where(better, lam * 0.3, lam * 8.0)
            f_prev = torch.where(better, f_new, f_prev)
        return p

    p = torch.zeros(7, dtype=dtype, device=dev)
    act = valid.to(dtype)
    p = gn(p, act, n_iters // 2)
    c1, c2 = chi2(p)
    inl = valid & (c1 < th2) & (c2 < th2)
    p = gn(p, inl.to(dtype), n_iters)
    c1, c2 = chi2(p)
    inl = valid & (c1 < th2) & (c2 < th2)
    R = so3_exp(p[:3]) @ R0
    return R, t0 + p[3:6], s0 * torch.exp(p[6]), inl, torch.sum(inl)
