"""The static projection edges of the local and human BAs: CUDA kernel +
plain twin.

For every edge (camera c, point p, observation (u, v, uR), uR < 0 mono) of
airdos_tpu's local BA (solvers/local_ba.py:43 _proj_residual and the
weighted products of gn_step, :107-129) and of the human BA's static half
(solvers/human_ba.py:188 residuals, :257-284), in one pass:

- gather R, t of the camera and x of the point; the residual e [3] (mono
  edges: third row 0), the Jacobians Jc [3, 6] (camera, left perturbation)
  and Jp [3, 3] (point), chi2 = ((e.e) info) scale and the depth z;
- the weight w = info scale (Huber when asked: delta / sqrt(chi2) past
  delta) x active;
- Gauss-Newton mode (``static_edge_blocks``): the rows of the BA's three
  segment sums, laid out as ``solvers/local_ba.schur_reduce`` sums them:
  cam [E, 42] = Jc^T w Jc (36, row-major) | -Jc^T w e (6), pt [E, 12] =
  Jp^T w Jp (9) | -Jp^T w e (3), pc [E, 18] = Jc^T w Jp (6 x 3);
- cost mode (``static_edge_cost``): rho [E] (the Huber cost 2 delta sq -
  delta^2 past delta when asked, else chi2), chi2 [E] and z [E]: the LM
  cost (summed by ``ops/lm_cost``) and the chi-square inlier passes.

scale is 1 in the local BA and SigmaStatic in the human BA; delta is
2.795483 on stereo edges and 2.447749 on mono ones.

On CUDA tensors both launch the sm_90a kernel of ``csrc/ba_static.cu`` (a
thread an edge; the projection is ``csrc/ba_project.cuh``, shared with
``ops/ba_human``) on the calling thread's current stream (built with nvcc
at first use into ``airdos_tpu_torch/_build/``, bound through ctypes) or
raise, and count the launch, by thread and stream priority too; on CPU
tensors they run ``static_edges_ref``.  The plain version spells out
every product and sum in the kernel's order with elementwise torch ops (no
einsum or bmm, whose summation order cannot be reproduced), so the two are
bit-equal.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from airdos_tpu_torch.ops import cuda_build
from airdos_tpu_torch.ops.cuda_build import check_tensor, consts

DELTA_STEREO = 2.795483           # sqrt of the chi2 thresholds 7.815 / 5.991
DELTA_MONO = 2.447749


class StaticRows(NamedTuple):
    cam: torch.Tensor   # [E, 42] Jc^T w Jc (36) | -Jc^T w e (6)
    pt: torch.Tensor    # [E, 12] Jp^T w Jp (9) | -Jp^T w e (3)
    pc: torch.Tensor    # [E, 18] Jc^T w Jp (6 x 3)


class StaticCost(NamedTuple):
    rho: torch.Tensor   # [E] robust cost (chi2 without Huber)
    chi2: torch.Tensor  # [E]
    z: torch.Tensor     # [E] the point's depth in the camera


# ------------------------------------------------------------ plain version

def project_ref(Rc, tc, X, obs, cam: Sequence[float]):
    """Per-edge residual and Jacobians of a stereo/mono projection, in
    csrc/ba_project.cuh's order.  Rc [E, 3, 3], tc [E, 3], X [E, 3], obs
    [E, 3] float32; cam (fx, fy, cx, cy, bf).  Returns e [E, 3], Jc [E, 3,
    6], Jp [E, 3, 3], z [E] and the stereo flags [E]."""
    fx, fy, cx, cy, bf = cam
    x, y, z = (((Rc[:, k, 0] * X[:, 0] + Rc[:, k, 1] * X[:, 1])
                + Rc[:, k, 2] * X[:, 2]) + tc[:, k] for k in range(3))
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = torch.reciprocal(zs)
    iz2 = iz * iz
    u = fx * x * iz + cx
    v = fy * y * iz + cy
    ur = u - bf * iz
    stereo = obs[:, 2] >= 0
    zero = torch.zeros_like(x)
    e = torch.stack([obs[:, 0] - u, obs[:, 1] - v,
                     torch.where(stereo, obs[:, 2] - ur, zero)], dim=1)
    # d (u, v, uR) / d xc = [[a, 0, p], [0, b, q], [a, 0, s]]
    a = fx * iz
    b = fy * iz
    nfx = -fx * x
    p = nfx * iz2
    q = -fy * y * iz2
    s = (nfx + bf) * iz2
    # Jc = -dproj [I | -[xc]x], Jp = -dproj R
    jc = [torch.stack([-a, zero, -p, -(p * y), p * x - a * z, a * y], 1),
          torch.stack([zero, -b, -q, b * z - q * y, q * x, -(b * x)], 1),
          torch.stack([-a, zero, -s, -(s * y), s * x - a * z, a * y], 1)]
    jp = [torch.stack([-(a * Rc[:, 0, j] + p * Rc[:, 2, j])
                       for j in range(3)], 1),
          torch.stack([-(b * Rc[:, 1, j] + q * Rc[:, 2, j])
                       for j in range(3)], 1),
          torch.stack([-(a * Rc[:, 0, j] + s * Rc[:, 2, j])
                       for j in range(3)], 1)]
    mono = ~stereo[:, None]
    jc[2] = jc[2].masked_fill(mono, 0.0)
    jp[2] = jp[2].masked_fill(mono, 0.0)
    return e, torch.stack(jc, 1), torch.stack(jp, 1), z, stereo


def sqnorm3(v):
    """(v0 v0 + v1 v1) + v2 v2 over the last axis of [..., 3]."""
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) \
        + v[..., 2] * v[..., 2]


def sqrt_rn(x):
    """The correctly rounded float32 square root (the kernels'
    __fsqrt_rn, torch's on CUDA).  torch's vectorized float32 sqrt on the
    CPU can be an ulp off; float64's is correctly rounded there, and
    rounding it to float32 gives the correctly rounded float32 root."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def huber_ref(chi2, delta, use_huber: bool):
    """(the Huber weight factor, rho) of chi2 [E] against delta [E] or a
    float32 0-dim tensor: delta / sq and 2 delta sq - delta^2 where sq =
    sqrt(max(chi2, 1e-12)) > delta; (None, chi2) without Huber."""
    if not use_huber:
        return None, chi2
    sq = sqrt_rn(torch.clamp(chi2, min=1e-12))
    past = sq > delta
    wh = torch.where(past, delta / sq, torch.ones_like(sq))
    rho = torch.where(past, 2 * delta * sq - delta * delta, chi2)
    return wh, rho


def normal_rows(J, w, e, K=None):
    """J^T w J [E, q, q] and -J^T w e [E, q] of float32 rows J [E, r, q],
    weights w [E] and residuals e [E, r] (and J^T w K [E, q, k] of rows K
    [E, r, k] when given), each entry computed in float64 and rounded to
    float32 once: the products (w J) J, (w J) e, (w J) K (w J exact), then
    the sum over r in order.  A step's gradient is the sum of many edges'
    -J^T w e that cancel near the optimum, so float32 rounding of every
    edge's entries would steer the LM's last steps along a flat valley."""
    f64 = torch.float64
    wJ = w.to(f64)[:, None, None] * J.to(f64)

    def contract(X):                    # sum_i (w J)[:, i, :]^T X[:, i, :]
        X = X.to(f64)
        acc = wJ[:, 0, :, None] * X[:, 0, None, :]
        for i in range(1, J.shape[1]):
            acc = acc + wJ[:, i, :, None] * X[:, i, None, :]
        return acc

    f32 = torch.float32
    H = contract(J).to(f32)
    b = (-contract(e[:, :, None])[..., 0]).to(f32)
    return (H, b) if K is None else (H, b, contract(K).to(f32))


def static_edges_ref(R, t, pts, e_cam, e_pt, e_obs, e_info,
                     active: Optional[torch.Tensor], cam, scale: float,
                     use_huber: bool, cost: bool):
    """Plain torch version: StaticCost when cost, else StaticRows."""
    e_cam, e_pt = e_cam.long(), e_pt.long()
    Rc = R[e_cam]
    e, Jc, Jp, z, stereo = project_ref(Rc, t[e_cam], pts[e_pt], e_obs, cam)
    chi2 = sqnorm3(e) * e_info * scale
    delta = torch.where(stereo, DELTA_STEREO, DELTA_MONO).to(torch.float32)
    wh, rho = huber_ref(chi2, delta, use_huber)
    if cost:
        return StaticCost(rho=rho, chi2=chi2, z=z)
    base = e_info * scale
    w = (base if wh is None else base * wh) * active
    E = e.shape[0]
    Hc, bc, W = normal_rows(Jc, w, e, Jp)
    Hp, bp = normal_rows(Jp, w, e)
    return StaticRows(cam=torch.cat([Hc.reshape(E, 36), bc], dim=1),
                      pt=torch.cat([Hp.reshape(E, 9), bp], dim=1),
                      pc=W.reshape(E, 18))


# ------------------------------------------------------------------ kernel

_SOURCE = cuda_build.CSRC / "ba_static.cu"
_SIGNATURES = {
    "airdos_static_edges": [ctypes.c_void_p] * 8 + [ctypes.c_int]
    + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4,
}
_kernel = None                   # the bound C entry point, once loaded

_counter = cuda_build.LaunchCounter()


def launches() -> int:
    """Kernel launches since the last reset_launches()."""
    return _counter.total


def launch_tally() -> dict:
    """{("static_edge_blocks", thread name, stream priority): launches}
    since the last reset_launches()."""
    return {("static_edge_blocks",) + key: n
            for key, n in _counter.tally().items()}


def reset_launches() -> None:
    _counter.reset()


def build():
    """Compile csrc/ba_static.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def static_edges_cuda(R, t, pts, e_cam, e_pt, e_obs, e_info,
                      active: Optional[torch.Tensor], cam, scale: float,
                      use_huber: bool, cost: bool):
    """Launch the sm_90a kernel on the current stream: static_edges_ref's
    StaticCost or StaticRows."""
    global _kernel
    dev = pts.device
    if not pts.is_cuda:
        raise ValueError(f"pts must be a CUDA tensor, got {pts.device}")
    f32, i32 = torch.float32, torch.int32
    C, P, E = R.shape[0], pts.shape[0], e_cam.shape[0]
    check_tensor("R", R, f32, (C, 3, 3), dev)
    check_tensor("t", t, f32, (C, 3), dev)
    check_tensor("pts", pts, f32, (P, 3), dev)
    check_tensor("e_cam", e_cam, i32, (E,), dev)
    check_tensor("e_pt", e_pt, i32, (E,), dev)
    check_tensor("e_obs", e_obs, f32, (E, 3), dev)
    check_tensor("e_info", e_info, f32, (E,), dev)
    if not cost:
        check_tensor("active", active, f32, (E,), dev)
    if _kernel is None:
        _kernel = cuda_build.library(_SOURCE,
                                     _SIGNATURES).airdos_static_edges
    if cost:
        out = StaticCost(*(torch.empty(E, dtype=f32, device=dev)
                           for _ in range(3)))
    else:
        out = StaticRows(*(torch.empty((E, k), dtype=f32, device=dev)
                           for k in (42, 12, 18)))
    with cuda_build.on_device(dev):
        err = _kernel(R.data_ptr(), t.data_ptr(), pts.data_ptr(),
                      e_cam.data_ptr(), e_pt.data_ptr(), e_obs.data_ptr(),
                      e_info.data_ptr(),
                      None if cost else active.data_ptr(), E,
                      consts(*cam, scale), int(use_huber), int(cost),
                      *(x.data_ptr() for x in out),
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"static_edge_blocks kernel launch failed: "
                           f"cudaError {err}")
    _counter.count(cuda_build.stream_priority(dev))
    return out


def _static_edges(*args):
    if args[2].is_cuda:
        return static_edges_cuda(*args)
    return static_edges_ref(*args)


def static_edge_blocks(R, t, pts, e_cam, e_pt, e_obs, e_info, active, cam,
                       scale: float, use_huber: bool) -> StaticRows:
    """The static edges' Gauss-Newton rows.  R [C, 3, 3], t [C, 3], pts [P,
    3], e_obs [E, 3], e_info [E], active [E] float32; e_cam, e_pt [E] int32;
    cam (fx, fy, cx, cy, bf).  CUDA tensors go to the kernel, CPU tensors
    to the plain version."""
    return _static_edges(R, t, pts, e_cam, e_pt, e_obs, e_info, active, cam,
                         scale, use_huber, False)


def static_edge_cost(R, t, pts, e_cam, e_pt, e_obs, e_info, cam,
                     scale: float, use_huber: bool) -> StaticCost:
    """The static edges' (rho, chi2, z), as static_edge_blocks takes its
    arguments."""
    return _static_edges(R, t, pts, e_cam, e_pt, e_obs, e_info, None, cam,
                         scale, use_huber, True)
