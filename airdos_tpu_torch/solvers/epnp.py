"""EPnP (Lepetit et al.) with batched RANSAC, for relocalization.

Rebuild of PnPsolver (reference src/PnPsolver.cc) as
airdos_tpu/solvers/epnp.py computes it: 4 control points by PCA,
barycentric coordinates, the null space of the 2n x 12 M matrix, betas by
Gauss-Newton on the 6 control-point distances from two case-1 starts, and
Horn R, t recovery; RANSAC with per-scale chi-square gates
(mvMaxError[octave] = 5.991 * sigma2, Tracking.cc:1538).

airdos_tpu vmaps one EPnP per hypothesis; here the hypotheses are the
leading batch dimension of every op (batched ``eigh`` and ``solve``), so
a RANSAC is one pass of batched small-matrix work.  The best hypothesis
is the first of the largest inlier count (``torch.argmax``, like
``jnp.argmax``).  The pose does not depend on the sign of an eigenvector:
the positive-depth rule flips the camera-frame points, and Horn's
quaternion absorbs its own sign.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from airdos_tpu_torch.solvers.align import eigh_finite, horn_align

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _solve(A, B):
    """Batched A X = B; a singular member (a degenerate sample) gets NaN,
    as jnp.linalg.solve gives it, where torch.linalg.solve raises."""
    X, info = torch.linalg.solve_ex(A, B)
    return torch.where((info == 0)[:, None, None], X,
                       torch.full_like(X, float("nan")))


def _control_points(pw: torch.Tensor, w: torch.Tensor):
    """pw [H, n, 3], w [H, n] -> control points [H, 4, 3] (centroid +
    PCA axes)."""
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    c0 = torch.sum(pw * wn[..., None], dim=-2)
    Q = (pw - c0[:, None, :]) * torch.sqrt(wn)[..., None]
    evals, evecs = eigh_finite(Q.transpose(-1, -2) @ Q)
    lam = torch.sqrt(torch.clamp(evals, min=1e-12))
    cps = [c0] + [c0 + lam[:, 2 - i, None] * evecs[:, :, 2 - i]
                  for i in range(3)]
    return torch.stack(cps, dim=1)


def _barycentric(pw: torch.Tensor, cps: torch.Tensor):
    """alphas [H, n, 4] with rows summing to 1 such that pw = alphas @ cps."""
    H, n = pw.shape[:2]
    one4 = torch.ones((H, 1, 4), dtype=pw.dtype, device=pw.device)
    A = torch.cat([cps.transpose(-1, -2), one4], dim=1)              # [H,4,4]
    B = torch.cat([pw.transpose(-1, -2),
                   torch.ones((H, 1, n), dtype=pw.dtype, device=pw.device)],
                  dim=1)
    eye = torch.eye(4, dtype=pw.dtype, device=pw.device)
    return _solve(A + 1e-9 * eye, B).transpose(-1, -2)


def _build_M(alphas, uv, w, fx, fy, cx, cy):
    """M [H, 2n, 12]; rows weighted by sqrt(w)."""
    H, n = alphas.shape[:2]
    sw = torch.sqrt(w)[..., None]
    a = alphas
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    zeros = torch.zeros_like(a)
    Mu = torch.stack([a * fx, zeros, a * (cx - u)], dim=3).reshape(H, n, 12) * sw
    Mv = torch.stack([zeros, a * fy, a * (cy - v)], dim=3).reshape(H, n, 12) * sw
    return torch.cat([Mu, Mv], dim=1)


def _rho_L(V):
    """The control-point distance system.  V [H, 12, 4]: the null-space
    basis (each column 4 control points x 3).  Returns G [H, 6, 4, 4]:
    |dx_p|^2 = beta^T G_p beta for x = sum_k beta_k v_k."""
    H = V.shape[0]
    v = V.transpose(-1, -2).reshape(H, 4, 4, 3)          # [H, basis, cp, 3]
    dv = torch.stack([v[:, :, i] - v[:, :, j] for i, j in _PAIRS], dim=2)
    return torch.einsum("hkpi,hlpi->hpkl", dv, dv)


def _betas_gn(G, rho, b, iters: int = 6):
    """Gauss-Newton on f_p(beta) = beta^T G_p beta - rho_p, batched."""
    eye = torch.eye(4, dtype=b.dtype, device=b.device)
    for _ in range(iters):
        f = torch.einsum("hk,hpkl,hl->hp", b, G, b) - rho
        J = 2.0 * torch.einsum("hpkl,hl->hpk", G, b)
        Hm = J.transpose(-1, -2) @ J + 1e-9 * eye
        g = torch.einsum("hpk,hp->hk", J, f)
        b = b - _solve(Hm, g[..., None])[..., 0]
    return b


def _project_err2(R, t, pw, uv, fx, fy, cx, cy):
    """Squared reprojection error [H, n] of world points through (R, t),
    and the camera-frame depth [H, n]."""
    xc = torch.einsum("hnj,hij->hni", pw, R) + t[:, None, :]
    z = xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = fx * xc[..., 0] / zs + cx
    v = fy * xc[..., 1] / zs + cy
    return (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2, zs


def epnp_pose(pw: torch.Tensor, uv: torch.Tensor, w: torch.Tensor,
              fx, fy, cx, cy):
    """Weighted EPnP, batched.  pw [H, n, 3] world, uv [H, n, 2] pixels,
    w [H, n] weights.  Returns (R [H, 3, 3], t [H, 3]) with
    x_cam = R x_world + t."""
    H = pw.shape[0]
    cps = _control_points(pw, w)
    alphas = _barycentric(pw, cps)
    M = _build_M(alphas, uv, w, fx, fy, cx, cy)
    _, evecs = eigh_finite(M.transpose(-1, -2) @ M)
    V = evecs[..., :4]                                    # 4 smallest
    G = _rho_L(V)
    rho = torch.stack([torch.sum((cps[:, i] - cps[:, j]) ** 2, dim=-1)
                       for i, j in _PAIRS], dim=1)        # [H, 6]

    cands = []
    for k in range(2):
        # case-1 start on basis k, scaled to match rho on average
        gkk = G[:, :, k, k]
        scale = torch.sqrt(torch.sum(rho * gkk, dim=-1) /
                           torch.clamp(torch.sum(gkk * gkk, dim=-1), min=1e-12))
        b0 = torch.zeros((H, 4), dtype=pw.dtype, device=pw.device)
        b0[:, k] = scale
        b = _betas_gn(G, rho, b0)
        x = (V @ b[..., None])[..., 0].reshape(H, 4, 3)   # camera-frame cps
        pc = alphas @ x
        # positive depth (the sign ambiguity of the null space)
        neg = torch.sum(w * pc[..., 2], dim=-1) < 0
        pc = torch.where(neg[:, None, None], -pc, pc)
        R, t, _ = horn_align(pc, pw, weights=w, fix_scale=True)
        err2, _ = _project_err2(R, t, pw, uv, fx, fy, cx, cy)
        cands.append((torch.sum(w * err2, dim=-1), R, t))
    (err0, R0, t0), (err1, R1, t1) = cands
    take0 = err0 <= err1
    return (torch.where(take0[:, None, None], R0, R1),
            torch.where(take0[:, None], t0, t1))


class PnPRansacResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor     # [n] bool
    n_inliers: torch.Tensor
    best: torch.Tensor        # index of the best hypothesis


def epnp_hypotheses(pw, uv, valid, max_err2, sample_idx, fx, fy, cx, cy):
    """Every hypothesis of the samples sample_idx [H, 4] at once: (R [H, 3,
    3], t [H, 3], inliers [H, n])."""
    sample_idx = sample_idx.to(torch.int64)
    Hn = sample_idx.shape[0]
    ones4 = torch.ones((Hn, 4), dtype=pw.dtype, device=pw.device)
    Rs, ts = epnp_pose(pw[sample_idx], uv[sample_idx], ones4, fx, fy, cx, cy)
    err2, z = _project_err2(Rs, ts, pw.expand(Hn, -1, -1),
                            uv.expand(Hn, -1, -1), fx, fy, cx, cy)
    return Rs, ts, valid & (err2 < max_err2) & (z > 0)


def epnp_refine(pw, uv, valid, max_err2, R_b, t_b, inl_b, best,
                fx, fy, cx, cy) -> PnPRansacResult:
    """Weighted EPnP over the best hypothesis's inliers (all points), kept
    when it has at least as many inliers as the hypothesis."""
    w_ref = inl_b.to(pw.dtype)[None] + 1e-6
    R_r, t_r = epnp_pose(pw[None], uv[None], w_ref, fx, fy, cx, cy)
    err2, z = _project_err2(R_r, t_r, pw[None], uv[None], fx, fy, cx, cy)
    inl_r = (valid & (err2[0] < max_err2) & (z[0] > 0))
    better = torch.sum(inl_r) >= torch.sum(inl_b)
    inl_f = torch.where(better, inl_r, inl_b)
    return PnPRansacResult(R=torch.where(better, R_r[0], R_b),
                           t=torch.where(better, t_r[0], t_b),
                           inliers=inl_f, n_inliers=torch.sum(inl_f),
                           best=best)


def epnp_ransac(pw, uv, valid, max_err2, sample_idx,
                fx, fy, cx, cy) -> PnPRansacResult:
    """EPnP RANSAC (reference PnPsolver::iterate semantics: minSet = 4,
    per-scale chi-square gate max_err2 [n]) over the precomputed samples
    sample_idx [H, 4]: every hypothesis at once, then weighted EPnP over
    the best hypothesis's inliers, kept when it has at least as many."""
    Rs, ts, inls = epnp_hypotheses(pw, uv, valid, max_err2, sample_idx,
                                   fx, fy, cx, cy)
    best = torch.argmax(torch.sum(inls, dim=-1))
    return epnp_refine(pw, uv, valid, max_err2, Rs[best], ts[best],
                       inls[best], best, fx, fy, cx, cy)
