"""EPnP (Lepetit et al.) with batched RANSAC, for relocalization.

Rebuild of PnPsolver (reference src/PnPsolver.cc) as
airdos_tpu/solvers/epnp.py computes it: 4 control points by PCA,
barycentric coordinates, the null space of the 2n x 12 M matrix, betas by
Gauss-Newton on the 6 control-point distances from two case-1 starts, and
Horn R, t recovery; RANSAC with per-scale chi-square gates
(mvMaxError[octave] = 5.991 * sigma2, Tracking.cc:1538).

airdos_tpu vmaps one EPnP per hypothesis.  On the card a RANSAC is two
launches of csrc/ransac.cu's EPnP kernel (ops/ransac_kernels.py: a block
a hypothesis, then one block for the refine) with a ``torch.argmax``
between them, and no host sync.  The plain versions
(``epnp_hypotheses_ref``, ``epnp_refine_ref``), which CPU tensors take,
make the hypotheses the leading batch dimension of every op (batched
``eigh`` and ``solve``).  The kernel fixes the eigensolver's free choices
(the PCA axes' signs, a minimal sample's null-space basis) by a rule
that the plain versions follow with ``canonical=True`` and the card
check holds it to; the CPU path keeps LAPACK's choices, airdos_tpu's on
the CPU (``epnp_pose`` says what they move).  The best hypothesis is
the first of the largest inlier count (``torch.argmax``, like
``jnp.argmax``).  A sample
that repeats an index is degenerate: a NaN pose and no inliers in both
versions (airdos_tpu's pose there is whatever its eigensolver picks in
the repeated null space; the reference draws samples without
replacement).  The pose does not depend on the sign of an eigenvector:
the positive-depth rule flips the camera-frame points, and Horn's
quaternion absorbs its own sign.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from airdos_tpu_torch.ops import ransac_kernels as rk
from airdos_tpu_torch.solvers.align import eigh_finite, horn_align

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _solve(A, B):
    """Batched A X = B; a singular member (a degenerate sample) gets NaN,
    as jnp.linalg.solve gives it, where torch.linalg.solve raises."""
    X, info = torch.linalg.solve_ex(A, B)
    return torch.where((info == 0)[:, None, None], X,
                       torch.full_like(X, float("nan")))


def _control_points(pw: torch.Tensor, w: torch.Tensor,
                    canonical: bool = False):
    """pw [H, n, 3], w [H, n] -> control points [H, 4, 3] (centroid +
    PCA axes).  With canonical each axis points where its largest
    component is positive (the first on ties), else where the eigensolver
    left it."""
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    c0 = torch.sum(pw * wn[..., None], dim=-2)
    Q = (pw - c0[:, None, :]) * torch.sqrt(wn)[..., None]
    evals, evecs = eigh_finite(Q.transpose(-1, -2) @ Q)
    if canonical:
        top = torch.gather(evecs, 1, torch.argmax(evecs.abs(), dim=1,
                                                  keepdim=True))
        evecs = torch.where(top < 0, -evecs, evecs)
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


def canonical_null_basis(V: torch.Tensor) -> torch.Tensor:
    """V [H, 12, 4] an orthonormal basis of M^T M's null space -> the basis
    of the same space whose vectors are the principal axes of diag(1, ...,
    12) restricted to it (ascending).  A minimal sample's M^T M has a
    4-dimensional null space, whose eigenvectors each eigensolver picks
    its own way; this basis is the space's own, so the case-1 starts, and
    the hypothesis, do not depend on the solver (the signs do not matter:
    the betas' equations are even, and the positive-depth rule flips)."""
    D = torch.arange(1, 13, dtype=V.dtype, device=V.device)
    _, Q = eigh_finite(V.transpose(-1, -2) @ (D[:, None] * V))
    return V @ Q


def epnp_pose(pw: torch.Tensor, uv: torch.Tensor, w: torch.Tensor,
              fx, fy, cx, cy, canonical: bool = False):
    """Weighted EPnP, batched.  pw [H, n, 3] world, uv [H, n, 2] pixels,
    w [H, n] weights.  Returns (R [H, 3, 3], t [H, 3]) with
    x_cam = R x_world + t.

    The pose depends on choices that the eigensolver makes: the signs of
    the PCA axes (the control points, and through them the case-1 starts,
    move the pose at the noise level: ~1e-3 at 0.5 px) and, for a minimal
    sample (n = 4), the basis of M^T M's 4-dimensional null space (its
    hypothesis can land anywhere).  With canonical they are fixed by rule,
    as csrc/ransac.cu fixes them: each PCA axis's largest component
    positive, and a minimal sample's basis canonical_null_basis.  Without
    it they are the eigensolver's: LAPACK's on the CPU, which are
    airdos_tpu's there."""
    H = pw.shape[0]
    cps = _control_points(pw, w, canonical)
    alphas = _barycentric(pw, cps)
    M = _build_M(alphas, uv, w, fx, fy, cx, cy)
    _, evecs = eigh_finite(M.transpose(-1, -2) @ M)
    V = evecs[..., :4]                                    # 4 smallest
    if canonical and pw.shape[1] == 4:
        V = canonical_null_basis(V)
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


def epnp_hypotheses_ref(pw, uv, valid, max_err2, sample_idx,
                        fx, fy, cx, cy, canonical: bool = False,
                        solve_dtype=torch.float64):
    """Plain version: every hypothesis of the samples sample_idx [H, 4] at
    once, (R [H, 3, 3], t [H, 3], inliers [H, n], counts [H]); with
    canonical the kernel's rule for the eigensolver's choices.  A
    hypothesis is solved in solve_dtype and rounded once, float64 as the
    kernel solves it: the 6 Gauss-Newton steps from a minimal sample's
    case-1 starts amplify float32's rounding, which moved 16% of the
    inlier counts of a path's hypotheses on the card (PERF.md section 6)."""
    sample_idx = sample_idx.to(torch.int64)
    Hn = sample_idx.shape[0]
    ones4 = torch.ones((Hn, 4), dtype=solve_dtype, device=pw.device)
    Rs, ts = epnp_pose(pw[sample_idx].to(solve_dtype),
                       uv[sample_idx].to(solve_dtype), ones4,
                       fx, fy, cx, cy, canonical)
    Rs, ts = Rs.to(pw.dtype), ts.to(pw.dtype)
    bad = rk.repeats(sample_idx)
    Rs = torch.where(bad[:, None, None], float("nan"), Rs)
    ts = torch.where(bad[:, None], float("nan"), ts)
    err2, z = _project_err2(Rs, ts, pw.expand(Hn, -1, -1),
                            uv.expand(Hn, -1, -1), fx, fy, cx, cy)
    inls = valid & (err2 < max_err2) & (z > 0)
    return Rs, ts, inls, torch.sum(inls, dim=-1)


def epnp_refine_ref(pw, uv, valid, max_err2, R_b, t_b, inl_b,
                    fx, fy, cx, cy, canonical: bool = False):
    """Plain version: the weighted EPnP over the best hypothesis's inliers
    (all points, weights inl_b + 1e-6), kept when it has at least as many
    inliers as the hypothesis: (R, t, inliers [n], n_inliers); with
    canonical the kernel's rule for the eigensolver's choices."""
    w_ref = inl_b.to(pw.dtype)[None] + 1e-6
    R_r, t_r = epnp_pose(pw[None], uv[None], w_ref, fx, fy, cx, cy,
                         canonical)
    err2, z = _project_err2(R_r, t_r, pw[None], uv[None], fx, fy, cx, cy)
    inl_r = (valid & (err2[0] < max_err2) & (z[0] > 0))
    better = torch.sum(inl_r) >= torch.sum(inl_b)
    inl_f = torch.where(better, inl_r, inl_b)
    return (torch.where(better, R_r[0], R_b), torch.where(better, t_r[0], t_b),
            inl_f, torch.sum(inl_f))


def epnp_hypotheses(pw, uv, valid, max_err2, sample_idx, fx, fy, cx, cy):
    """Every hypothesis of the samples sample_idx [H, 4]: (R [H, 3, 3], t
    [H, 3], inliers [H, n], counts [H]); one launch on CUDA tensors."""
    if pw.is_cuda:
        return rk.epnp_hypotheses_cuda(pw, uv, valid, max_err2,
                                       sample_idx.to(torch.int32),
                                       fx, fy, cx, cy)
    return epnp_hypotheses_ref(pw, uv, valid, max_err2, sample_idx,
                               fx, fy, cx, cy)


def epnp_refine(pw, uv, valid, max_err2, R_b, t_b, inl_b, best,
                fx, fy, cx, cy) -> PnPRansacResult:
    """Weighted EPnP over the best hypothesis's inliers (all points), kept
    when it has at least as many inliers as the hypothesis; one launch on
    CUDA tensors."""
    refine = rk.epnp_refine_cuda if pw.is_cuda else epnp_refine_ref
    R, t, inl, n_inl = refine(pw, uv, valid, max_err2, R_b, t_b, inl_b,
                              fx, fy, cx, cy)
    return PnPRansacResult(R=R, t=t, inliers=inl, n_inliers=n_inl, best=best)


def epnp_ransac(pw, uv, valid, max_err2, sample_idx,
                fx, fy, cx, cy) -> PnPRansacResult:
    """EPnP RANSAC (reference PnPsolver::iterate semantics: minSet = 4,
    per-scale chi-square gate max_err2 [n]) over the precomputed samples
    sample_idx [H, 4]: every hypothesis at once, then weighted EPnP over
    the best hypothesis's inliers, kept when it has at least as many."""
    Rs, ts, inls, counts = epnp_hypotheses(pw, uv, valid, max_err2,
                                           sample_idx, fx, fy, cx, cy)
    best = torch.argmax(counts)
    return epnp_refine(pw, uv, valid, max_err2, Rs[best], ts[best],
                       inls[best], best, fx, fy, cx, cy)
