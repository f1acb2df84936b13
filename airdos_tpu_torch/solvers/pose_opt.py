"""Motion-only bundle adjustment (pose optimization).

Behavioral rebuild of Optimizer::PoseOptimization (reference
src/Optimizer.cc:232-429): one SE3 camera vertex, unary stereo/mono
projection edges with fixed world points, 4 rounds x 10 LM iterations,
chi-square gating (5.991 mono / 7.815 stereo) re-classifying outliers
between rounds, Huber kernel dropped from round 3 on.

Edges live in fixed-size padded tensors.  ``pose_optimize`` packs the
edges and scalars once (``pack_problem``) and then:

- on a CUDA tensor launches the sm_90a kernel of ``csrc/pose_lm.cu``, the
  whole 4 x 10 protocol in one launch (a thread block cluster of
  ``CLUSTER`` blocks) on the calling thread's current
  stream (built with nvcc at first use into ``airdos_tpu_torch/_build/``,
  bound through ctypes) or raises, and counts the launch, by thread and
  stream priority too; the host reads nothing;
- on a CPU tensor runs ``pose_optimize_ref``, the plain torch version,
  on the unpacked edges.  Every accept/reject decision of its LM is a
  torch.where, so its 40 iterations never read a device value on the
  host either.

The kernel design and what bounds it are described at the top of the
CUDA source.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from airdos_tpu_torch.geometry.se3 import (se3_compose, se3_exp, se3_inverse,
                                           se3_log, so3_hat)
from airdos_tpu_torch.ops import cuda_build
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


def pose_optimize_ref(R0: torch.Tensor, t0: torch.Tensor,
                      xw: torch.Tensor,          # [N, 3] fixed world points
                      obs: torch.Tensor,         # [N, 3] (u, v, uR); uR < 0 => mono
                      inv_sigma2: torch.Tensor,  # [N] per-edge information scale
                      valid: torch.Tensor,       # [N] bool
                      fx, fy, cx, cy, bf,
                      huber_delta_mono: float = 2.447749,   # sqrt(5.991)
                      huber_delta_stereo: float = 2.795483,  # sqrt(7.815)
                      prior_w_rot: float = 0.0, prior_w_trans: float = 0.0
                      ) -> PoseOptResult:
    """Plain torch version: all-tensor pose optimization.  Mono edges are
    rows with obs[:, 2] < 0.

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


# ------------------------------------------------------- the CUDA kernel

_SOURCE = cuda_build.CSRC / "pose_lm.cu"
_SIGNATURES = {
    "airdos_pose_lm": [ctypes.c_void_p] * 4 + [ctypes.c_int]
    + [ctypes.c_float] * 9 + [ctypes.c_void_p],
}
# the edges a call takes (a block's flags, a byte an edge of its range,
# stay well under the 48 KB of shared memory a block gets without opting in)
MAX_EDGES = 40960
# csrc/pose_lm.cu's launch: one thread block cluster of CLUSTER blocks, each
# with a range of the edges (cluster_edges)
CLUSTER = 8
_kernel = None                   # the bound C entry point, once loaded

_counter = cuda_build.LaunchCounter()


def launches() -> int:
    """Kernel launches since the last reset_launches()."""
    return _counter.total


def launch_tally() -> dict:
    """{("pose_lm", thread name, stream priority): launches} since the
    last reset_launches()."""
    return {("pose_lm",) + key: n for key, n in _counter.tally().items()}


def reset_launches() -> None:
    _counter.reset()


def cluster_edges(n: int, rank: int) -> range:
    """The edges block `rank` of the kernel's cluster takes: a contiguous
    range of ceil(n / CLUSTER), strided over the block's threads (its
    flags are a byte an edge of the block's dynamic shared memory)."""
    per = -(-n // CLUSTER)
    lo = min(n, rank * per)
    return range(lo, min(n, lo + per))


def build():
    """Compile csrc/pose_lm.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


class PoseProblem(NamedTuple):
    """One call's inputs as both versions take them."""
    pose0: torch.Tensor       # [12] float32: R0 row-major, then t0
    edges: torch.Tensor       # [N, 8] float32: xw, u, v, uR, inv_sigma2, valid (1/0)
    scalars: Tuple[float, ...]  # fx, fy, cx, cy, bf, the two Huber deltas,
                                # the rotation and translation prior weights


def pack_problem(R0, t0, xw, obs, inv_sigma2, valid, fx, fy, cx, cy, bf,
                 huber_delta_mono, huber_delta_stereo, prior_w_rot,
                 prior_w_trans) -> PoseProblem:
    """The edges side by side in one float32 tensor (a 16-byte aligned row
    an edge) and the scalars rounded to float32, as the kernel takes them;
    the plain version computes with the same float32 values."""
    f32 = torch.float32
    pose0 = torch.cat([R0.reshape(9).to(f32), t0.reshape(3).to(f32)])
    edges = torch.cat([xw.to(f32), obs.to(f32), inv_sigma2.to(f32)[:, None],
                       valid.to(f32)[:, None]], dim=1)
    scalars = tuple(float(np.float32(v)) for v in (
        fx, fy, cx, cy, bf, huber_delta_mono, huber_delta_stereo,
        prior_w_rot, prior_w_trans))
    return PoseProblem(pose0, edges, scalars)


def pose_lm_ref(pose0: torch.Tensor, edges: torch.Tensor,
                scalars) -> PoseOptResult:
    """The plain version on a packed problem."""
    fx, fy, cx, cy, bf, dm, ds, wr, wt = scalars
    return pose_optimize_ref(pose0[:9].reshape(3, 3), pose0[9:], edges[:, 0:3],
                             edges[:, 3:6], edges[:, 6], edges[:, 7] > 0,
                             fx, fy, cx, cy, bf, huber_delta_mono=dm,
                             huber_delta_stereo=ds, prior_w_rot=wr,
                             prior_w_trans=wt)


def pose_lm_launch(pose0: torch.Tensor, edges: torch.Tensor, scalars):
    """Launch the sm_90a kernel on the current stream and count the
    launch.  Returns its raw outputs: out [16] float32 (R row-major, t, then as int32 the inlier
    count and the active edges summed over the build passes, the work
    the bound counts) and inlier [N] bool."""
    global _kernel
    if not edges.is_cuda:
        raise ValueError(f"edges must be a CUDA tensor, got {edges.device}")
    if edges.dtype != torch.float32 or edges.dim() != 2 \
            or edges.shape[1] != 8 or not edges.is_contiguous():
        raise ValueError("edges must be a contiguous float32 [N, 8] tensor, "
                         f"got {edges.dtype} {tuple(edges.shape)}")
    if pose0.device != edges.device or pose0.dtype != torch.float32 \
            or pose0.shape != (12,) or not pose0.is_contiguous():
        raise ValueError(f"pose0 must be a contiguous float32 [12] tensor on "
                         f"{edges.device}, got {pose0.dtype} "
                         f"{tuple(pose0.shape)} on {pose0.device}")
    n = edges.shape[0]
    if n > MAX_EDGES:
        raise ValueError(f"{n} edges exceed the kernel's {MAX_EDGES}")
    if edges.data_ptr() % 16:
        raise ValueError("edges must start on a 16-byte boundary")
    if len(scalars) != 9:
        raise ValueError(f"9 scalars expected, got {len(scalars)}")
    if _kernel is None:
        _kernel = cuda_build.library(_SOURCE, _SIGNATURES).airdos_pose_lm
    out = torch.empty(16, dtype=torch.float32, device=edges.device)
    inlier = torch.empty(n, dtype=torch.bool, device=edges.device)
    with cuda_build.on_device(edges.device):
        err = _kernel(pose0.data_ptr(), edges.data_ptr(), out.data_ptr(),
                      inlier.data_ptr(), n, *scalars,
                      torch.cuda.current_stream(edges.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pose_lm kernel launch failed: cudaError {err}")
    _counter.count(cuda_build.stream_priority(edges.device))
    return out, inlier


def pose_lm_cuda(pose0: torch.Tensor, edges: torch.Tensor,
                 scalars) -> PoseOptResult:
    """The whole pose LM in one launch of the sm_90a kernel; the result is
    views of its outputs (no host sync)."""
    out, inlier = pose_lm_launch(pose0, edges, scalars)
    return PoseOptResult(R=out[:9].view(3, 3), t=out[9:12], inlier=inlier,
                         n_inliers=out[12:13].view(torch.int32)[0]
                         .to(torch.int64))


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
    """Pose optimization (pose_optimize_ref's arguments and result): one
    kernel launch on CUDA tensors, the plain version on CPU tensors."""
    prob = pack_problem(R0, t0, xw, obs, inv_sigma2, valid, fx, fy, cx, cy,
                        bf, huber_delta_mono, huber_delta_stereo,
                        prior_w_rot, prior_w_trans)
    if prob.edges.is_cuda:
        return pose_lm_cuda(*prob)
    return pose_lm_ref(*prob)
