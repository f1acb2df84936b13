"""Lie-group operations on SO(3) and SE(3), the subset tracking uses.

Batch-friendly torch functions (every op broadcasts over leading axes).
Poses are (R, t): rotation [..., 3, 3] and translation [..., 3].  Tangent
vectors follow the g2o::SE3Quat convention of the reference's solvers:
[upsilon (trans), omega (rot)].  Small-angle branches are torch.where
Taylor guards, as in airdos_tpu/geometry/se3.py, so no branch reads a
device value on the host.
"""
from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", A, x)


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [..., 3, 3] from [..., 3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    W = so3_hat(w)
    W2 = torch.matmul(W, W)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    v = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], dim=-1)
    sin_t_n = 0.5 * torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1), min=1e-12))
    theta = torch.atan2(sin_t_n, cos_t)
    sin_t = torch.sin(theta)
    small = torch.abs(sin_t) < 1e-6
    near_pi = cos_t < -0.999

    scale_generic = torch.where(
        small, 0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.where(small, torch.ones_like(sin_t), sin_t)))
    w_generic = scale_generic[..., None] * v

    # near theta = pi: the axis comes from the symmetric part
    S = 0.5 * (R + R.transpose(-1, -2))
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp((diag - cos_t[..., None]) /
                          torch.clamp(1.0 - cos_t[..., None], min=1e-12), min=0.0)
    axis = torch.sqrt(torch.clamp(axis_sq, min=1e-12))
    sign = torch.where(v >= 0, 1.0, -1.0).to(R.dtype)
    k = torch.argmax(axis, dim=-1)
    ref_sign = torch.gather(sign, -1, k[..., None])
    axis = axis * sign * ref_sign
    nrm = torch.linalg.norm(axis, dim=-1, keepdim=True)
    axis = axis / torch.clamp(nrm, min=1e-12)
    w_pi = axis * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    W = so3_hat(w)
    W2 = torch.matmul(W, W)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta + _EPS))
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * W2


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    W = so3_hat(w)
    W2 = torch.matmul(W, W)
    half_theta = 0.5 * theta
    sin_h = torch.where(small, torch.ones_like(half_theta), torch.sin(half_theta))
    cot = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                      (1.0 - half_theta * torch.cos(half_theta) / sin_h)
                      / (theta2 + _EPS * _EPS))
    return _eye_like(W) - 0.5 * W + cot[..., None, None] * W2


def se3_exp(xi: torch.Tensor):
    """Tangent [..., 6] ([upsilon, omega]) -> (R [..., 3, 3], t [..., 3])."""
    v, w = xi[..., :3], xi[..., 3:]
    return so3_exp(w), _mv(_so3_left_jacobian(w), v)


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> tangent [..., 6] ([upsilon, omega])."""
    w = so3_log(R)
    return torch.cat([_mv(_so3_left_jacobian_inv(w), t), w], dim=-1)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): x -> Ra (Rb x + tb) + ta."""
    return torch.matmul(Ra, Rb), _mv(Ra, tb) + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, t)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] (x, y, z, w — TUM order) -> rotation matrix."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], dim=-1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], dim=-1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


# ---------------------------------------------------------------- Sim(3)

def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """x -> sa Ra (sb Rb x + tb) + ta."""
    return torch.matmul(Ra, Rb), sa[..., None] * _mv(Ra, tb) + ta, sa * sb


def sim3_inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * _mv(Rt, t), s_inv


def _sim3_V(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim(3) V matrix [..., 3, 3] of g2o's sim3.h (t = V upsilon) in
    its three regimes."""
    s = torch.exp(sigma)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = so3_hat(w)
    W2 = torch.matmul(W, W)
    one = torch.ones_like(sigma)
    small_s = torch.abs(sigma) < 1e-6
    small_t = theta2 < 1e-8
    sigma_safe = torch.where(small_s, one, sigma)
    a = torch.where(small_s & small_t, one, sigma * sigma + theta2)
    s_cos = s * torch.cos(theta)
    s_sin = s * torch.sin(theta)
    c1 = (s - 1.0) / sigma_safe
    B_gen = (sigma * s_sin + theta * (1.0 - s_cos)) / (theta * a)
    C_gen = (c1 - ((s_cos - 1.0) * sigma + s_sin * theta) / a) / \
        torch.where(small_t, one, theta2)
    # sigma ~ 0: V is the SE(3) left Jacobian
    B_se3 = torch.where(small_t, 0.5 - theta2 / 24.0,
                        (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    C_se3 = torch.where(small_t, 1.0 / 6.0 - theta2 / 120.0,
                        (theta - torch.sin(theta)) / (theta2 * theta + _EPS))
    # sigma != 0, theta ~ 0
    B_sig = ((sigma - 1.0) * s + 1.0) / (sigma_safe * sigma_safe)
    A = torch.where(small_s, one, c1)
    B = torch.where(small_s, B_se3, torch.where(small_t, B_sig, B_gen))
    C = torch.where(small_s, C_se3,
                    torch.where(small_t, torch.zeros_like(C_gen), C_gen))
    return A[..., None, None] * _eye_like(W) + B[..., None, None] * W + \
        C[..., None, None] * W2


def sim3_exp(xi: torch.Tensor):
    """Tangent [..., 7] ([upsilon, omega, sigma]) -> (R, t, s)."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return so3_exp(w), _mv(_sim3_V(w, sigma), v), torch.exp(sigma)


def sim3_log(R, t, s):
    """(R, t, s) -> tangent [..., 7], the inverse of sim3_exp: V from
    (w, sigma), then V v = t solved.  (airdos_tpu rebuilds V column by
    column by probing sim3_exp with the basis vectors: the same values, in
    three times the operations.)"""
    w = so3_log(R)
    sigma = torch.log(s)
    V = _sim3_V(w, sigma)
    v = torch.linalg.solve(V, t[..., None])[..., 0]
    return torch.cat([v, w, sigma[..., None]], dim=-1)


# ------------------------------------------------------- numpy (host-side)
def se3_log_np(R, t):
    """Host-side SE3 log for single poses (the per-frame velocity
    bookkeeping in tracking)."""
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(cos)
    if th < 1e-8:
        w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                      R[1, 0] - R[0, 1]]) * 0.5
        return np.concatenate([t, w])
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]]) / (2.0 * np.sin(th))
    w = th * axis
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    Jinv = (np.eye(3) - 0.5 * W +
            (1.0 / th ** 2 - (1.0 + np.cos(th)) / (2.0 * th * np.sin(th)))
            * (W @ W))
    return np.concatenate([Jinv @ t, w])


def se3_exp_np(xi):
    """Host-side SE3 exp for single tangents (inverse of se3_log_np)."""
    v, w = np.asarray(xi[:3], np.float64), np.asarray(xi[3:], np.float64)
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-8:
        R = np.eye(3) + W
        J = np.eye(3) + 0.5 * W
    else:
        W2 = W @ W
        R = np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th ** 2 * W2
        J = (np.eye(3) + (1 - np.cos(th)) / th ** 2 * W +
             (th - np.sin(th)) / th ** 3 * W2)
    return R, J @ v


def project_so3_np(R):
    """Nearest rotation matrix (Frobenius) via 3x3 SVD — host-side.

    The solver output carries float32 non-orthonormality that compounds
    through the velocity composition Rv = Rcw_f @ Rcw_{f-1}.T; projecting
    once per host-boundary set_pose caps it at one frame's worth."""
    R64 = np.asarray(R, np.float64)
    U, _, Vt = np.linalg.svd(R64)
    Ro = U @ Vt
    if np.linalg.det(Ro) < 0:
        Ro = (U * np.array([1.0, 1.0, -1.0])) @ Vt
    return Ro
