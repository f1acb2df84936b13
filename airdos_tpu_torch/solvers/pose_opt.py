"""Motion-only bundle adjustment (pose optimization).

Behavioral rebuild of Optimizer::PoseOptimization (reference
src/Optimizer.cc:232-429): one SE3 camera vertex, unary stereo/mono
projection edges with fixed world points, 4 rounds x 10 LM iterations,
chi-square gating (5.991 mono / 7.815 stereo) re-classifying outliers
between rounds, Huber kernel dropped from round 3 on.

Edges live in fixed-size padded tensors.  Every accept/reject decision of
the LM is a torch.where on the device, so the 40 iterations never read a
device value on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from airdos_tpu_torch.geometry.se3 import (se3_compose, se3_exp, se3_inverse,
                                           se3_log, so3_hat)
from airdos_tpu_torch.solvers.smallmat import inv6x6

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
N_ROUNDS = 4
N_ITERS = 10


class PoseOptResult(NamedTuple):
    R: torch.Tensor          # [3, 3] optimized Tcw rotation
    t: torch.Tensor          # [3]
    inlier: torch.Tensor     # [N] bool per-edge inlier classification
    n_inliers: torch.Tensor  # int64


def _residual_jac(R, t, xw, obs, row_mask, fx, fy, cx, cy, bf):
    """Residual e = obs - h(R xw + t) [N, 3] and Jacobian de/dxi [N, 3, 6]
    (xi = [v, w], left-multiplicative update exp(xi) * T like g2o
    VertexSE3Expmap), and the camera depth z [N].

    row_mask [N, 3] is 1 except for the third row of mono edges: they keep
    the stereo form's first two rows, which are exactly the mono residual
    and Jacobian, and a zero third row (airdos_tpu evaluates the two forms
    separately and selects the same values)."""
    xc = torch.einsum("ij,nj->ni", R, xw) + t
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / zs
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    pred = torch.stack([u, v, u - bf * iz], dim=-1)
    zero = torch.zeros_like(x)
    Jp = torch.stack([
        torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1),
        torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1),
        torch.stack([fx * iz, zero, (-fx * x + bf) * iz2], dim=-1),
    ], dim=-2)                                                # [N, 3, 3]
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(xw.shape[0], 3, 3)
    Jxc = torch.cat([eye, -so3_hat(xc)], dim=-1)              # [N, 3, 6]
    J = -torch.einsum("nij,njk->nik", Jp, Jxc) * row_mask[:, :, None]
    return (obs - pred) * row_mask, J, z


def pose_optimize(R0: torch.Tensor, t0: torch.Tensor,
                  xw: torch.Tensor,          # [N, 3] fixed world points
                  obs: torch.Tensor,         # [N, 3] (u, v, uR); uR < 0 => mono
                  inv_sigma2: torch.Tensor,  # [N] per-edge information scale
                  valid: torch.Tensor,       # [N] bool
                  fx, fy, cx, cy, bf,
                  huber_delta_mono: float = 2.447749,   # sqrt(5.991)
                  huber_delta_stereo: float = 2.795483,  # sqrt(7.815)
                  prior_w_rot: float = 0.0, prior_w_trans: float = 0.0
                  ) -> PoseOptResult:
    """All-tensor pose optimization.  Mono edges are rows with obs[:, 2] < 0.

    prior_w_rot / prior_w_trans (information weights, 1/sigma^2) add a weak
    SE3 prior anchoring the solution to the initial pose, as in
    airdos_tpu (OptimizerConfig.motion_prior_sigma_*); 0 is the reference
    protocol."""
    is_stereo = obs[:, 2] >= 0.0
    dtype, dev = R0.dtype, R0.device
    w_prior = torch.tensor([prior_w_trans] * 3 + [prior_w_rot] * 3,
                           dtype=dtype, device=dev)
    use_prior = prior_w_rot > 0 or prior_w_trans > 0
    Ri0, ti0 = se3_inverse(R0, t0)
    delta = torch.where(is_stereo, huber_delta_stereo, huber_delta_mono).to(dtype)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    row_mask = torch.ones_like(obs)
    row_mask[:, 2] = is_stereo.to(dtype)

    def chi2_of(R, t):
        e, _, z = _residual_jac(R, t, xw, obs, row_mask, fx, fy, cx, cy, bf)
        return torch.sum(e * e, dim=-1) * inv_sigma2, z > 0.0

    def build_system(R, t, w_active, use_huber: bool):
        e, J, _ = _residual_jac(R, t, xw, obs, row_mask, fx, fy, cx, cy, bf)
        chi2 = torch.sum(e * e, dim=-1) * inv_sigma2
        if use_huber:
            sqrt_chi = torch.sqrt(torch.clamp(chi2, min=1e-12))
            robust = sqrt_chi > delta
            w_huber = torch.where(robust, delta / sqrt_chi,
                                  torch.ones_like(chi2))
            rho = torch.where(robust, 2 * delta * sqrt_chi - delta * delta,
                              chi2)
        else:
            w_huber, rho = torch.ones_like(chi2), chi2
        w = inv_sigma2 * w_huber * w_active
        Jw = J * w[:, None, None]
        H = torch.einsum("nik,nij->kj", Jw, J)
        b = -torch.einsum("nik,ni->k", Jw, e)
        rho = torch.where(torch.isfinite(rho), rho, torch.full_like(rho, 1e30))
        total = torch.sum(rho * w_active)
        if use_prior:
            ep = se3_log(*se3_compose(R, t, Ri0, ti0))
            H = H + torch.diag(w_prior)
            b = b - w_prior * ep
            total = total + torch.sum(w_prior * ep * ep)
        return H, b, total

    def lm_round(R, t, w_active, use_huber: bool):
        # the system at the current pose is carried from the iteration that
        # accepted it: the same values airdos_tpu recomputes at the top of
        # every iteration
        H, b, f_prev = build_system(R, t, w_active, use_huber)
        lam = torch.tensor(1e-5, dtype=dtype, device=dev)
        for _ in range(N_ITERS):
            # trace-scaled damping floor: the closed-form inverse loses
            # precision on ill-conditioned H, so keep the smallest
            # eigenvalue away from zero relative to the system's scale
            floor = 1e-6 * torch.trace(H) / 6.0 + 1e-9
            Hd = H + lam * torch.diag(torch.diagonal(H)) + floor * eye6
            dx = inv6x6(Hd) @ b
            Rn, tn = se3_compose(*se3_exp(dx), R, t)
            Hn, bn, f_new = build_system(Rn, tn, w_active, use_huber)
            better = f_new < f_prev
            R = torch.where(better, Rn, R)
            t = torch.where(better, tn, t)
            H = torch.where(better, Hn, H)
            b = torch.where(better, bn, b)
            lam = torch.where(better, lam * 0.5, lam * 4.0)
            f_prev = torch.where(better, f_new, f_prev)
        return R, t

    R, t = R0, t0
    inlier = valid
    th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO).to(dtype)
    # behind-camera points never enter the system (the reference checks
    # isDepthPositive between rounds; this also does it up front)
    _, depth_ok = chi2_of(R, t)
    for rnd in range(N_ROUNDS):
        active = inlier & valid & depth_ok
        R, t = lm_round(R, t, active.to(dtype), rnd < 2)
        chi, depth_ok = chi2_of(R, t)
        inlier = valid & (chi <= th) & depth_ok

    return PoseOptResult(R=R, t=t, inlier=inlier, n_inliers=torch.sum(inlier))
