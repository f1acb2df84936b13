"""OptimizeSim3 in one launch: a CUDA kernel + its plain twin.

Loop closing refines the RANSAC's Sim3 S12 by Gauss-Newton on mutual
projection edges with an inlier re-check (reference
Optimizer::OptimizeSim3, src/Optimizer.cc:2474-2660; airdos_tpu
solvers/sim3.py:82 optimize_sim3):

- ``optimize_sim3_ref`` is the plain version: float32 eager torch, each
  step the residuals, their closed-form Jacobians with respect to (w, u,
  sigma) (R = exp(w) R0, t = t0 + u, s = s0 e^sigma), two [2n, 7]
  products, a damped ``torch.linalg.solve`` and the trial cost (~60-80
  launches a step, and the solve's info read on the host).
- ``sim3_opt_cuda`` launches ``csrc/sim3_opt.cu`` on the calling
  thread's current stream (built with nvcc at first use into
  ``airdos_tpu_torch/_build/``, bound through ctypes) or raises: the
  whole schedule (n_iters // 2 steps over valid, the re-check, n_iters
  steps over the inliers, the final chi2) in float64 in one block, the
  outputs written on the device with no host sync; it counts the launch,
  by thread and stream priority too.  solvers/sim3.py optimize_sim3 takes
  one or the other by the tensors' device.

The kernel sums H and g in float64 in a fixed block order and rounds the
pose once; the plain version rounds every op to float32.  They agree to
float32 rounding of a converged solve (the card check holds R, t and s
within 1e-4 and >= 99% of the inlier flags).
"""
from __future__ import annotations

import ctypes
import struct

import numpy as np
import torch

from airdos_tpu_torch.geometry.se3 import _so3_left_jacobian, so3_exp, \
    so3_hat
from airdos_tpu_torch.ops import cuda_build

R_TOL = T_TOL = S_RTOL = 1e-4     # the card check against the plain version
INLIER_SHARE = 0.99


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def optimize_sim3_ref(R0, t0, s0,
                  x1, obs1, sig1,         # points in cam1 + their obs in cam1
                  x2, obs2, sig2,         # points in cam2 + their obs in cam2
                  valid,
                  fx, fy, cx, cy,
                  th2: float = 10.0, fix_scale: bool = True,
                  n_iters: int = 10):
    """Plain version: GN on the 7-DoF (6 with a fixed scale) S12 with
    mutual projection residuals, S12 x2 against obs1 and S12^-1 x1 against
    obs2, in float32.  Returns (R, t, s, inlier mask, inlier count)."""
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


# ------------------------------------------------------------------ kernel

# csrc/sim3_opt.cu Sim3OptParams: 3 counts and flags, 13 pointers, 6
# float32
_PARAMS = struct.Struct("<16q6f")
_SOURCE = cuda_build.CSRC / "sim3_opt.cu"
_SIGNATURES = {"airdos_sim3_opt": [ctypes.c_void_p, ctypes.c_void_p]}
_lib = None                     # the loaded library, once built

_counter = cuda_build.LaunchCounter()


def launches() -> int:
    """sim3_opt launches since the last reset_launches()."""
    return _counter.total


def launch_tally() -> dict:
    """{("sim3_opt", thread name, stream priority): launches} since the
    last reset_launches()."""
    return {("sim3_opt",) + key: n for key, n in _counter.tally().items()}


def reset_launches() -> None:
    _counter.reset()


def build():
    """Compile csrc/sim3_opt.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def sim3_opt_cuda(R0, t0, s0, x1, obs1, sig1, x2, obs2, sig2, valid,
                  fx, fy, cx, cy, th2: float = 10.0, fix_scale: bool = True,
                  n_iters: int = 10):
    """The whole OptimizeSim3 in one launch on the current stream:
    (R [3, 3], t [3], s [], inliers [n], n_inliers []), views of the
    kernel's outputs."""
    global _lib
    dev = x1.device
    if not x1.is_cuda:
        raise ValueError(f"x1 must be a CUDA tensor, got {dev}")
    if x1.dim() != 2:
        raise ValueError(f"x1 must be [n, 3], got {tuple(x1.shape)}")
    n = x1.shape[0]
    if not isinstance(s0, torch.Tensor):
        s0 = torch.full((), float(s0), dtype=torch.float32, device=dev)
    f32 = torch.float32
    for name, x, shape in (
            ("R0", R0, (3, 3)), ("t0", t0, (3,)), ("s0", s0, ()),
            ("x1", x1, (n, 3)), ("obs1", obs1, (n, 2)), ("sig1", sig1, (n,)),
            ("x2", x2, (n, 3)), ("obs2", obs2, (n, 2)), ("sig2", sig2, (n,))):
        cuda_build.check_tensor(name, x, f32, shape, dev)
    cuda_build.check_tensor("valid", valid, torch.bool, (n,), dev)
    if n == 0 or n_iters < 0:
        raise ValueError(f"{n} pairs, {n_iters} iterations")
    out = torch.empty(13, dtype=f32, device=dev)
    inl = torch.empty(n, dtype=torch.bool, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    block = ctypes.create_string_buffer(_PARAMS.pack(
        n, int(n_iters), int(bool(fix_scale)), R0.data_ptr(), t0.data_ptr(),
        s0.data_ptr(), x1.data_ptr(), obs1.data_ptr(), sig1.data_ptr(),
        x2.data_ptr(), obs2.data_ptr(), sig2.data_ptr(), valid.data_ptr(),
        out.data_ptr(), inl.data_ptr(), count.data_ptr(),
        *(float(np.float32(v)) for v in (fx, fy, cx, cy, th2)), 0.0))
    if _lib is None:
        _lib = cuda_build.library(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(dev)
    with cuda_build.on_device(dev):
        err = _lib.airdos_sim3_opt(ctypes.addressof(block), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"sim3_opt kernel launch failed: cudaError {err}")
    _counter.count(stream.priority)
    return out[:9].view(3, 3), out[9:12], out[12], inl, count


def held(got, plain):
    """The kernel's result against the plain version's (each (R, t, s,
    inliers, count)): R within R_TOL, t within T_TOL (m), s within S_RTOL
    of itself, INLIER_SHARE of the flags equal.  Returns (held, stats)."""
    R_gap = float((got[0] - plain[0]).abs().max())
    t_gap = float((got[1] - plain[1]).abs().max())
    s_gap = float(((got[2] - plain[2]) / plain[2]).abs())
    share = float((got[3] == plain[3]).double().mean())
    stats = dict(R_gap=R_gap, t_gap=t_gap, s_gap=s_gap, inlier_share=share,
                 n_inliers=(int(got[4]), int(plain[4])))
    return (R_gap <= R_TOL and t_gap <= T_TOL and s_gap <= S_RTOL
            and share >= INLIER_SHARE), stats
