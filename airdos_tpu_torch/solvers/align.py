"""Closed-form point-set alignment (Horn 1987), batched.

Core of the reference's Sim3Solver (src/Sim3Solver.cc:226-365: the
quaternion is the top eigenvector of the 4x4 N matrix, the scale the
symmetric ratio) and of EPnP's final R, t recovery, as
airdos_tpu/solvers/align.py computes it.  Every op batches over leading
dimensions, so a RANSAC's hypotheses are one batch of small eigen
problems.  ``torch.linalg.eigh`` sorts eigenvalues ascending like
``jnp.linalg.eigh``; the eigenvector's sign is free and the quaternion
absorbs it (q and -q give one rotation).
"""
from __future__ import annotations

import torch

from airdos_tpu_torch.geometry.se3 import quat_to_rot


def eigh_finite(A: torch.Tensor):
    """torch.linalg.eigh over a batch whose degenerate members (a RANSAC
    sample that repeats points) may hold NaN or inf: those get NaN
    eigenvalues and eigenvectors, as jnp.linalg.eigh gives them, where
    torch's LAPACK and cuSOLVER paths raise instead."""
    ok = torch.isfinite(A).flatten(-2).all(-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    evals, evecs = torch.linalg.eigh(torch.where(ok[..., None, None], A, eye))
    nan = torch.full_like(evecs, float("nan"))
    return (torch.where(ok[..., None], evals, nan[..., 0]),
            torch.where(ok[..., None, None], evecs, nan))


def horn_align(P1: torch.Tensor, P2: torch.Tensor,
               weights: torch.Tensor | None = None,
               fix_scale: bool = True):
    """(R, t, s) minimizing || P1 - (s R P2 + t) ||^2.

    P1, P2: [..., N, 3]; weights: [..., N] optional.
    Returns R [..., 3, 3], t [..., 3], s [...]."""
    w = torch.ones(P1.shape[:-1], dtype=P1.dtype, device=P1.device) \
        if weights is None else weights
    wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    c1 = torch.sum(P1 * wn[..., None], dim=-2)
    c2 = torch.sum(P2 * wn[..., None], dim=-2)
    Q1 = P1 - c1[..., None, :]
    Q2 = P2 - c2[..., None, :]

    # M = sum w q2 q1^T: R maps frame 2 into frame 1 (Horn's convention)
    M = torch.einsum("...ni,...n,...nj->...ij", Q2, wn, Q1)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    _, evecs = eigh_finite(N)
    q_wxyz = evecs[..., :, -1]                  # largest eigenvalue
    R = quat_to_rot(torch.stack([q_wxyz[..., 1], q_wxyz[..., 2],
                                 q_wxyz[..., 3], q_wxyz[..., 0]], dim=-1))

    if fix_scale:
        s = torch.ones(P1.shape[:-2], dtype=P1.dtype, device=P1.device)
    else:
        # symmetric-ratio scale: s = sum w q1 . (R q2) / sum w |q2|^2
        RQ2 = torch.einsum("...ij,...nj->...ni", R, Q2)
        num = torch.sum(wn * torch.sum(Q1 * RQ2, dim=-1), dim=-1)
        den = torch.sum(wn * torch.sum(Q2 * Q2, dim=-1), dim=-1)
        s = num / torch.clamp(den, min=1e-12)
    t = c1 - s[..., None] * torch.einsum("...ij,...j->...i", R, c2)
    return R, t, s
