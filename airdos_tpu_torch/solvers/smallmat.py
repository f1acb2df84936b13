"""Small-matrix solves that stay on the device.

The pose LM solves a damped 6x6 system 40 times per call.  The closed
forms below keep that solve inside a handful of elementwise ops on the
device (no LAPACK call, no host sync), and the LM's trace-scaled damping
floor (solvers/pose_opt.py) was tuned to their precision in airdos_tpu.
The local BA solves its damped-SPD reduced camera system with
``cho_solve_dense``.
"""
from __future__ import annotations

import torch


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det). M: [..., 3, 3]."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = torch.stack([torch.stack([A, D, G], -1),
                       torch.stack([B, E, H], -1),
                       torch.stack([C, F, I], -1)], -2)
    return adj * inv_det[..., None, None]


def inv6x6(M: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 inverse by 3x3-blockwise Schur complement.
    M: [..., 6, 6] with an invertible leading 3x3 block (true for the
    damped SPD pose blocks this is used on)."""
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    C = M[..., 3:, :3]
    D = M[..., 3:, 3:]
    Ai = inv3x3(A)
    S = D - C @ Ai @ B
    Si = inv3x3(S)
    AiB = Ai @ B
    CAi = C @ Ai
    top_left = Ai + AiB @ Si @ CAi
    top_right = -AiB @ Si
    bot_left = -Si @ CAi
    return torch.cat([torch.cat([top_left, top_right], dim=-1),
                      torch.cat([bot_left, Si], dim=-1)], dim=-2)


def cho_solve_dense(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for damped-SPD H via Cholesky (no pivoting).
    H: [D, D]; b: [D] or [D, K].

    cholesky_ex leaves the factorization status on the device (no host
    sync inside an LM loop); where it failed the result is NaN, as
    jax.lax.linalg.cholesky gives, so the caller's cost guard rejects the
    step."""
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
    b2 = b[:, None] if b.dim() == 1 else b
    y = torch.linalg.solve_triangular(L, b2, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[:, 0] if b.dim() == 1 else x
