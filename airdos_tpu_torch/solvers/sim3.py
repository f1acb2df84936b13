"""Sim3 / SE3 solvers for loop closing, as airdos_tpu/solvers/sim3.py
computes them:

- ``sim3_ransac``: Horn closed form on 3-point samples with mutual
  reprojection chi-square inlier gates (reference Sim3Solver,
  src/Sim3Solver.cc; scale fixed for stereo).  On the card two launches
  of csrc/ransac.cu's Horn kernel (ops/ransac_kernels.py: a block a
  hypothesis, then one block for the refine) with a ``torch.argmax``
  between them; the plain versions (``sim3_hypotheses_ref``,
  ``sim3_refine_ref``), which CPU tensors take, make the hypotheses one
  leading batch dimension (batched Horn, one batched ``eigh``).  A sample
  that repeats an index is degenerate: a NaN pose and no inliers in both.
- ``optimize_sim3``: Gauss-Newton on the KF-pair Sim3 with mutual
  projection edges and an inlier re-check (Optimizer::OptimizeSim3,
  src/Optimizer.cc:2474-2660): one launch of csrc/sim3_opt.cu on the card
  (ops/sim3_opt_kernels.py), its plain version ``optimize_sim3_ref`` on
  the CPU.  airdos_tpu builds its 7x7 system from ``jax.jacfwd``; both
  versions here use closed forms of the same parametrization (R = exp(w)
  R0, t = t0 + u, s = s0 e^sigma), which agree with torch.func.jacfwd's
  to float32 rounding.  With a fixed scale the scale row and column are
  pinned to the identity.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from airdos_tpu_torch.ops import ransac_kernels as rk
from airdos_tpu_torch.ops import sim3_opt_kernels as sok
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


def sim3_hypotheses_ref(x1, x2, valid, max_err1, max_err2, sample_idx,
                        fx, fy, cx, cy, fix_scale: bool = True):
    """Plain version: every Horn hypothesis of the samples sample_idx [H,
    3] at once, (R [H, 3, 3], t [H, 3], s [H], inliers [H, n], counts
    [H])."""
    reproj = sim3_inlier_test(x1, x2, valid, max_err1, max_err2,
                              fx, fy, cx, cy)
    idx = sample_idx.to(torch.int64)
    Rs, ts, ss = horn_align(x1[idx], x2[idx], fix_scale=fix_scale)
    bad = rk.repeats(idx)
    Rs = torch.where(bad[:, None, None], float("nan"), Rs)
    ts = torch.where(bad[:, None], float("nan"), ts)
    ss = torch.where(bad, float("nan"), ss)
    inls = reproj(Rs, ts, ss)
    return Rs, ts, ss, inls, torch.sum(inls, dim=-1)


def sim3_refine_ref(x1, x2, valid, max_err1, max_err2, R_b, t_b, s_b,
                    inl_b, fx, fy, cx, cy, fix_scale: bool = True):
    """Plain version: Horn over the best hypothesis's inliers (all pairs,
    weights inl_b + 1e-6), kept when it has at least as many inliers as
    the hypothesis: (R, t, s, inliers [n], n_inliers)."""
    reproj = sim3_inlier_test(x1, x2, valid, max_err1, max_err2,
                              fx, fy, cx, cy)
    w = inl_b.to(x1.dtype) + 1e-6
    R_r, t_r, s_r = horn_align(x1, x2, weights=w, fix_scale=fix_scale)
    inl_r = reproj(R_r[None], t_r[None], s_r[None])[0]
    better = torch.sum(inl_r) >= torch.sum(inl_b)
    inl_f = torch.where(better, inl_r, inl_b)
    return (torch.where(better, R_r, R_b), torch.where(better, t_r, t_b),
            torch.where(better, s_r, s_b), inl_f, torch.sum(inl_f))


def sim3_hypotheses(x1, x2, valid, max_err1, max_err2, sample_idx,
                    fx, fy, cx, cy, fix_scale: bool = True):
    """Every Horn hypothesis of sample_idx [H, 3]: (R [H, 3, 3], t [H, 3],
    s [H], inliers [H, n], counts [H]); one launch on CUDA tensors."""
    if x1.is_cuda:
        return rk.horn_hypotheses_cuda(x1, x2, valid, max_err1, max_err2,
                                       sample_idx.to(torch.int32),
                                       fx, fy, cx, cy, fix_scale)
    return sim3_hypotheses_ref(x1, x2, valid, max_err1, max_err2,
                               sample_idx, fx, fy, cx, cy, fix_scale)


def sim3_refine(x1, x2, valid, max_err1, max_err2, R_b, t_b, s_b, inl_b,
                best, fx, fy, cx, cy,
                fix_scale: bool = True) -> Sim3RansacResult:
    """Horn over the best hypothesis's inliers, kept when it has at least
    as many inliers as the hypothesis; one launch on CUDA tensors."""
    refine = rk.horn_refine_cuda if x1.is_cuda else sim3_refine_ref
    R, t, s, inl, n_inl = refine(x1, x2, valid, max_err1, max_err2, R_b,
                                 t_b, s_b, inl_b, fx, fy, cx, cy, fix_scale)
    return Sim3RansacResult(R=R, t=t, s=s, inliers=inl, n_inliers=n_inl,
                            best=best)


def sim3_ransac(x1, x2, valid,            # [n, 3] camera-frame points, both KFs
                sample_idx,               # [H, 3]
                max_err1, max_err2,       # [n] chi2 gates (9.210 * sigma2)
                fx, fy, cx, cy,
                fix_scale: bool = True) -> Sim3RansacResult:
    """S12 (x1 ~ S12 x2) by RANSAC over 3-point Horn alignments with mutual
    reprojection checks."""
    Rs, ts, ss, inls, counts = sim3_hypotheses(
        x1, x2, valid, max_err1, max_err2, sample_idx, fx, fy, cx, cy,
        fix_scale)
    best = torch.argmax(counts)
    return sim3_refine(x1, x2, valid, max_err1, max_err2, Rs[best],
                       ts[best], ss[best], inls[best], best, fx, fy, cx, cy,
                       fix_scale)


def optimize_sim3(R0, t0, s0,
                  x1, obs1, sig1,         # points in cam1 + their obs in cam1
                  x2, obs2, sig2,         # points in cam2 + their obs in cam2
                  valid,
                  fx, fy, cx, cy,
                  th2: float = 10.0, fix_scale: bool = True,
                  n_iters: int = 10):
    """GN on the 7-DoF (6 with a fixed scale) S12 with mutual projection
    residuals: S12 x2 against obs1 and S12^-1 x1 against obs2.  Returns
    (R, t, s, inlier mask, inlier count): one sim3_opt launch on CUDA
    tensors, optimize_sim3_ref on CPU tensors."""
    args = (R0, t0, s0, x1, obs1, sig1, x2, obs2, sig2, valid,
            fx, fy, cx, cy, th2, fix_scale, n_iters)
    if x1.is_cuda:
        return sok.sim3_opt_cuda(*args)
    return sok.optimize_sim3_ref(*args)
