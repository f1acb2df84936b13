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
  delta^2 past delta when asked, else chi2), chi2 [E] and z [E]: the
  chi-square inlier passes;
- cost-sum mode (``static_edge_cost_sum``): the family's LM cost, the
  0-dim ``ops/lm_cost.lm_cost_ref(rho, active)`` of the cost mode's rho, in
  its fixed order, without rho going to memory.

scale is 1 in the local BA and SigmaStatic in the human BA; delta is
2.795483 on stereo edges and 2.447749 on mono ones.

On CUDA tensors all three launch the sm_90a kernels of
``csrc/ba_static.cu`` (Gauss-Newton: ``LANES`` lanes an edge, each
computing the entries ``gn_lane_plan`` gives it; cost: a thread an edge;
cost sum: a cluster of 8 blocks; the projection is
``csrc/ba_project.cuh``, shared with ``ops/ba_human``) on the calling
thread's current stream (built with nvcc at first use into
``airdos_tpu_torch/_build/``, bound through ctypes) or raise, and count
the launch, by thread and stream priority too; on CPU tensors they run
``static_edges_ref``.  The plain version spells out every product and sum
in the kernel's order with elementwise torch ops (no einsum or bmm, whose
summation order cannot be reproduced), so the two are bit-equal.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from airdos_tpu_torch.ops import cuda_build
from airdos_tpu_torch.ops.cuda_build import check_tensor, consts
from airdos_tpu_torch.ops.lm_cost import lm_cost_ref

DELTA_STEREO = 2.795483           # sqrt of the chi2 thresholds 7.815 / 5.991
DELTA_MONO = 2.447749

# what a launch computes (the C entry point's mode)
ROWS, COST, COST_SUM = 0, 1, 2

# csrc/ba_static.cu's Gauss-Newton mode: LANES lanes an edge, each with at
# most SLOTS entries of the edge's 72 (cam 0-41, pt 42-53, pc 54-71)
LANES, SLOTS = 8, 7
NONE = 127                        # a plan word's empty second place


class StaticRows(NamedTuple):
    cam: torch.Tensor   # [E, 42] Jc^T w Jc (36) | -Jc^T w e (6)
    pt: torch.Tensor    # [E, 12] Jp^T w Jp (9) | -Jp^T w e (3)
    pc: torch.Tensor    # [E, 18] Jc^T w Jp (6 x 3)


class StaticCost(NamedTuple):
    rho: torch.Tensor   # [E] robust cost (chi2 without Huber)
    chi2: torch.Tensor  # [E]
    z: torch.Tensor     # [E] the point's depth in the camera


# ------------------------------------------------------------ lane plan

def gn_entries() -> List[Tuple[int, int, int, int, bool]]:
    """The distinct entries of an edge's 72 Gauss-Newton floats, in the
    plan's order: (q, p, first place, second place or NONE, negate), each
    sum_r (w A[r, q]) A[r, p] over the columns A = [Jc (0-5) | Jp (6-8) |
    e (9)].  J^T w J is symmetric bit for bit (w A[r, q] is exact in
    float64, so (w A_q) A_p and (w A_p) A_q are one rounding of the same
    product), so its upper triangle goes to both places."""
    out = []
    for lo, hi, base, b_base in ((0, 6, 0, 36), (6, 9, 42, 51)):
        size = hi - lo
        for q in range(lo, hi):
            for p in range(q, hi):
                a, b = q - lo, p - lo
                out.append((q, p, base + a * size + b,
                            NONE if a == b else base + b * size + a, False))
        out.extend((q, 9, b_base + q - lo, NONE, True) for q in range(lo, hi))
    out.extend((q, p, 54 + 3 * q + p - 6, NONE, False)
               for q in range(6) for p in range(6, 9))
    return out


def gn_lane_plan() -> List[List[int]]:
    """[LANES][SLOTS] plan words: entry k of gn_entries goes to lane k %
    LANES, slot k // LANES; a word is q | p << 4 | first << 8 | second <<
    15 | negate << 22, -1 for an empty slot (csrc/ba_static.cu Plan)."""
    plan = [[-1] * SLOTS for _ in range(LANES)]
    for k, (q, p, first, second, neg) in enumerate(gn_entries()):
        plan[k % LANES][k // LANES] = (q | p << 4 | first << 8
                                       | second << 15 | int(neg) << 22)
    return plan


def plan_entry(word: int) -> Tuple[int, int, int, int, bool]:
    """A plan word unpacked: (q, p, first place, second place, negate)."""
    return (word & 15, (word >> 4) & 15, (word >> 8) & 127,
            (word >> 15) & 127, bool((word >> 22) & 1))


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
                     use_huber: bool, mode: int):
    """Plain torch version: StaticRows (mode ROWS), StaticCost (COST) or
    the 0-dim LM cost (COST_SUM)."""
    e_cam, e_pt = e_cam.long(), e_pt.long()
    Rc = R[e_cam]
    e, Jc, Jp, z, stereo = project_ref(Rc, t[e_cam], pts[e_pt], e_obs, cam)
    chi2 = sqnorm3(e) * e_info * scale
    delta = torch.where(stereo, DELTA_STEREO, DELTA_MONO).to(torch.float32)
    wh, rho = huber_ref(chi2, delta, use_huber)
    if mode == COST_SUM:
        return lm_cost_ref(rho, active)
    if mode == COST:
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
    + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5,
}
_kernel = None                   # the bound C entry point, once loaded
_PLAN = (ctypes.c_int32 * (LANES * SLOTS))(
    *(w for lane in gn_lane_plan() for w in lane))

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
                      use_huber: bool, mode: int):
    """Launch the sm_90a kernel of `mode` on the current stream:
    static_edges_ref's StaticRows, StaticCost or LM cost (no launch for
    the rows or costs of no edge; the cost sum of no edge is a launch that
    writes 0)."""
    global _kernel
    dev = pts.device
    if not pts.is_cuda:
        raise ValueError(f"pts must be a CUDA tensor, got {pts.device}")
    if mode not in (ROWS, COST, COST_SUM):
        raise ValueError(f"mode {mode}")
    f32, i32 = torch.float32, torch.int32
    C, P, E = R.shape[0], pts.shape[0], e_cam.shape[0]
    check_tensor("R", R, f32, (C, 3, 3), dev)
    check_tensor("t", t, f32, (C, 3), dev)
    check_tensor("pts", pts, f32, (P, 3), dev)
    check_tensor("e_cam", e_cam, i32, (E,), dev)
    check_tensor("e_pt", e_pt, i32, (E,), dev)
    check_tensor("e_obs", e_obs, f32, (E, 3), dev)
    check_tensor("e_info", e_info, f32, (E,), dev)
    if mode != COST:
        check_tensor("active", active, f32, (E,), dev)
    if _kernel is None:
        _kernel = cuda_build.library(_SOURCE,
                                     _SIGNATURES).airdos_static_edges
    if mode == COST_SUM:
        out = torch.empty((), dtype=f32, device=dev)
        ptrs = (out.data_ptr(), None, None)
    else:
        out = (StaticCost(*(torch.empty(E, dtype=f32, device=dev)
                            for _ in range(3))) if mode == COST else
               StaticRows(*(torch.empty((E, k), dtype=f32, device=dev)
                            for k in (42, 12, 18))))
        ptrs = tuple(x.data_ptr() for x in out)
        if E == 0:                          # nothing to launch
            return out
    with cuda_build.on_device(dev):
        err = _kernel(R.data_ptr(), t.data_ptr(), pts.data_ptr(),
                      e_cam.data_ptr(), e_pt.data_ptr(), e_obs.data_ptr(),
                      e_info.data_ptr(),
                      None if mode == COST else active.data_ptr(), E,
                      consts(*cam, scale), int(use_huber), int(mode),
                      _PLAN if mode == ROWS else None, *ptrs,
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
                         scale, use_huber, ROWS)


def static_edge_cost(R, t, pts, e_cam, e_pt, e_obs, e_info, cam,
                     scale: float, use_huber: bool) -> StaticCost:
    """The static edges' (rho, chi2, z), as static_edge_blocks takes its
    arguments."""
    return _static_edges(R, t, pts, e_cam, e_pt, e_obs, e_info, None, cam,
                         scale, use_huber, COST)


def static_edge_cost_sum(R, t, pts, e_cam, e_pt, e_obs, e_info, active, cam,
                         scale: float, use_huber: bool) -> torch.Tensor:
    """The static family's LM cost, a 0-dim float32 tensor bit-equal to
    ops/lm_cost.lm_cost_ref(static_edge_cost(...).rho, active), as
    static_edge_blocks takes its arguments."""
    return _static_edges(R, t, pts, e_cam, e_pt, e_obs, e_info, active, cam,
                         scale, use_huber, COST_SUM)
