"""The global BA's conjugate-gradient half-steps: two CUDA kernels + their
plain twins.

airdos_tpu's global BA (solvers/global_ba.py:113 ``schur_matvec``, :133
``precond``, :143 ``cg_body``) solves the reduced camera system S dx = b
by preconditioned CG without forming S: each iteration is S p, two
gathers and two scatter-adds over the edge table, and the CG's vector
algebra.  Here an iteration is two launches:

- ``schur_point`` (the point half): for each point, the sum over its
  edges of Wcp_e^T (p * cam_free)[cam_e], in the edges' order in the
  point-keyed segment index (``make_segments``), times Hpp^-1: z [P, 3].
- ``schur_camera`` (the camera half and the CG update): for each camera,
  back = the sum over its edges of Wcp_e z[pt_e] in the camera-keyed
  index's order, Ap = (Hcc_d xm - back) cam_free + xm (1 - cam_free) with
  xm = p cam_free (global_ba.py:152-159); then the last block to finish
  runs the update over all cameras: alpha, x, r, z = D^-1 r, r.z, beta
  and p, with the 1e-20 guards of global_ba.py:174 and :179.

Each walk reads Wcp as rows of 18 floats in its own order: ``walk_rows``
gathers them once a Gauss-Newton step.  The segments' rows outside
``keep`` (the BA's padding and invalid edges) are walked by no segment.

The dot products p.Ap and r.z sum in one fixed order (``fixed_dot``):
each camera's six products in sequence, then LANES lanes, lane j summing
the cameras j, j + LANES, ... in sequence, then a halving tree.  Every
product, sum and division is one correctly rounded float32 operation in
the plain versions' order, so the kernels' outputs are bit-equal to the
plain versions' (csrc/ba_global.cu says how).

With ``raw=True`` each kernel leaves a mesh rank's sums, before Hpp^-1
and before the update: the caller psums them and finishes the iteration
itself (solvers/global_ba.py eagerly, on every rank).  ``matvec`` by
Hpp^-1 and ``cg_update`` are those steps in the kernels' order.

On CUDA tensors each wrapper launches its entry point of
``csrc/ba_global.cu`` on the calling thread's current stream (built with
nvcc at first use into ``airdos_tpu_torch/_build/``, bound through
ctypes) or raises, and counts the launch, by thread and stream priority
too; on CPU tensors it runs the plain version (any float dtype).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from airdos_tpu_torch.ops import cuda_build
from airdos_tpu_torch.ops.cuda_build import check_tensor
from airdos_tpu_torch.ops.segment_kernels import Segments, segment_sum_ref

LANES = 256                    # the update's lanes: csrc/ba_global.cu kThreads
GUARD = 1e-20                  # global_ba.py:174, :179


class Walk(NamedTuple):
    """One segment index's rows in walk order: row i of a walk is edge
    rows[i]; the rows offsets[s]:offsets[s + 1] are segment s's, in edge
    order; rows past offsets[n] belong to no segment."""
    rows: torch.Tensor      # [E] int64 edge of each row
    other: torch.Tensor     # [E] int32 the edge's other end (camera / point)
    key: torch.Tensor       # [E] int64 segment of each row (n: none)
    offsets: torch.Tensor   # [n + 1] int32
    n: int


def make_walk(seg: Segments, other: torch.Tensor) -> Walk:
    """The walk of `seg` (make_segments' index); other [E]: each edge's
    other end."""
    rows = seg.perm.to(torch.int64)
    return Walk(rows=rows, other=other[rows].to(torch.int32).contiguous(),
                key=seg.key[rows], offsets=seg.offsets, n=seg.n)


def walk_rows(wcp: torch.Tensor, walk: Walk) -> torch.Tensor:
    """Wcp [E, 6, 3] as [E, 18] rows in the walk's order."""
    return wcp.reshape(wcp.shape[0], 18).index_select(0, walk.rows)


class CGState(NamedTuple):
    """The CG's state, updated in place by ``schur_camera``: x, r, p [C,
    6], rz [1]; ap [C, 6] and part [C] are scratch, count [1] int32 the
    last block's counter (zero between launches)."""
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    ap: torch.Tensor
    part: torch.Tensor
    count: torch.Tensor


# ------------------------------------------------------------ plain version

def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M [n, k, m] (or [n, k * m]) times v [n, m]: out[:, i] = M[:, i, 0]
    v[:, 0] + M[:, i, 1] v[:, 1] + ..., left to right."""
    n, m = v.shape
    M = M.reshape(n, -1, m)
    acc = M[:, :, 0] * v[:, 0:1]
    for j in range(1, m):
        acc = acc + M[:, :, j] * v[:, j:j + 1]
    return acc


def fixed_sum(q: torch.Tensor) -> torch.Tensor:
    """The sum of q [n] in the kernels' order: LANES lanes, lane j adding
    q[j], q[j + LANES], ... in sequence from 0, then a halving tree.
    Returns [1]."""
    m = max(1, -(-q.shape[0] // LANES))
    q = torch.cat([q, q.new_zeros(m * LANES - q.shape[0])]).reshape(m, LANES)
    acc = q.new_zeros(LANES)
    for i in range(m):
        acc = acc + q[i]
    off = LANES // 2
    while off:
        acc = acc[:off] + acc[off:2 * off]
        off //= 2
    return acc


def fixed_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) of two [n, k]: each row's k products in sequence, then
    fixed_sum over the rows.  Returns [1]."""
    q = a[:, 0] * b[:, 0]
    for k in range(1, a.shape[1]):
        q = q + a[:, k] * b[:, k]
    return fixed_sum(q)


def cg_start(b_red: torch.Tensor, d_inv: torch.Tensor) -> CGState:
    """The CG's first state: x = 0, r = b_red, p = D^-1 r, rz = r.p."""
    z = matvec(d_inv, b_red)
    C = b_red.shape[0]
    return CGState(x=torch.zeros_like(b_red), r=b_red.clone(), p=z,
                   rz=fixed_dot(b_red, z), ap=torch.empty_like(b_red),
                   part=b_red.new_empty(C),
                   count=torch.zeros(1, dtype=torch.int32,
                                     device=b_red.device))


def point_sums_ref(w_p, walk_p: Walk, x, cam_free):
    """Each point's sum of Wcp_e^T (x cam_free)[cam_e] over its edges in
    walk order: [P, 3]."""
    xm = x * cam_free[:, None]
    xg = xm[walk_p.other.long()]
    W = w_p.reshape(-1, 6, 3)
    y = W[:, 0, :] * xg[:, 0:1]
    for k in range(1, 6):
        y = y + W[:, k, :] * xg[:, k:k + 1]
    return segment_sum_ref(y, walk_p.key, walk_p.n)


def camera_sums_ref(w_c, walk_c: Walk, z):
    """Each camera's sum of Wcp_e z[pt_e] over its edges in walk order:
    [C, 6]."""
    zg = z[walk_c.other.long()]
    W = w_c.reshape(-1, 6, 3)
    y = W[:, :, 0] * zg[:, 0:1]
    for m in range(1, 3):
        y = y + W[:, :, m] * zg[:, m:m + 1]
    return segment_sum_ref(y, walk_c.key, walk_c.n)


def cg_update(state: CGState, back, hcc_d, d_inv, cam_free) -> None:
    """One CG iteration's update from back = W z (global_ba.py:158-181),
    written into state."""
    x, r, p, rz = state.x, state.r, state.p, state.rz
    f = cam_free[:, None]
    xm = p * f
    ap = (matvec(hcc_d, xm) - back) * f + xm * (1.0 - f)
    pap = fixed_dot(p, ap)
    zero = torch.zeros_like(rz)
    alpha = torch.where(torch.abs(pap) > GUARD, rz / pap, zero)
    x_new = x + alpha * p
    r_new = r - alpha * ap
    z = matvec(d_inv, r_new)
    rz_new = fixed_dot(r_new, z)
    beta = torch.where(torch.abs(rz) > GUARD, rz_new / rz, zero)
    p_new = z + beta * p
    x.copy_(x_new)
    r.copy_(r_new)
    p.copy_(p_new)
    rz.copy_(rz_new)


def schur_point_ref(w_p, walk_p, x, cam_free, hpp_inv, raw=False):
    s = point_sums_ref(w_p, walk_p, x, cam_free)
    return s if raw else matvec(hpp_inv, s)


def schur_camera_ref(w_c, walk_c, z, state, hcc_d, d_inv, cam_free,
                     raw=False):
    back = camera_sums_ref(w_c, walk_c, z)
    if raw:
        return back
    cg_update(state, back, hcc_d, d_inv, cam_free)
    return state


# ------------------------------------------------------------------ kernel

_SOURCE = cuda_build.CSRC / "ba_global.cu"
_SIGNATURES = {
    "airdos_schur_point": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 2,
    "airdos_schur_camera": [ctypes.c_void_p] * 13 + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 2,
}
_lib = None                      # the loaded library, once built

_point_counter = cuda_build.LaunchCounter()
_camera_counter = cuda_build.LaunchCounter()


def point_launches() -> int:
    """schur_point launches since the last reset_launches()."""
    return _point_counter.total


def camera_launches() -> int:
    """schur_camera launches since the last reset_launches()."""
    return _camera_counter.total


def launch_tally() -> dict:
    """{(entry point, thread name, stream priority): launches} since the
    last reset_launches()."""
    return {**{("schur_point",) + key: n
               for key, n in _point_counter.tally().items()},
            **{("schur_camera",) + key: n
               for key, n in _camera_counter.tally().items()}}


def reset_launches() -> None:
    _point_counter.reset()
    _camera_counter.reset()


def build():
    """Compile csrc/ba_global.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def _library():
    global _lib
    if _lib is None:
        _lib = cuda_build.library(_SOURCE, _SIGNATURES)
    return _lib


def _check_walk(name, w, walk: Walk, dev):
    E = w.shape[0]
    check_tensor(f"{name} rows", w, torch.float32, (E, 18), dev)
    check_tensor(f"{name} other", walk.other, torch.int32, (E,), dev)
    check_tensor(f"{name} offsets", walk.offsets, torch.int32,
                 (walk.n + 1,), dev)
    if E * 18 >= 2 ** 31:
        raise ValueError(f"{E} edges exceed the kernels' indexing")


def schur_point_cuda(w_p, walk_p, x, cam_free, hpp_inv, raw=False):
    """Launch the point half on the current stream: schur_point_ref's z
    (or, raw, its sums)."""
    dev = x.device
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {dev}")
    C, P = x.shape[0], walk_p.n
    _check_walk("point walk", w_p, walk_p, dev)
    check_tensor("x", x, torch.float32, (C, 6), dev)
    check_tensor("cam_free", cam_free, torch.float32, (C,), dev)
    check_tensor("hpp_inv", hpp_inv, torch.float32, (P, 3, 3), dev)
    out = torch.empty((P, 3), dtype=torch.float32, device=dev)
    if P == 0:                  # the entry point would launch nothing
        return out
    stream = torch.cuda.current_stream(dev)
    with cuda_build.on_device(dev):
        err = _library().airdos_schur_point(
            w_p.data_ptr(), walk_p.other.data_ptr(),
            walk_p.offsets.data_ptr(), x.data_ptr(), cam_free.data_ptr(),
            hpp_inv.data_ptr(), P, int(raw), out.data_ptr(),
            stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"schur_point kernel launch failed: cudaError "
                           f"{err}")
    _point_counter.count(stream.priority)
    return out


def schur_camera_cuda(w_c, walk_c, z, state, hcc_d, d_inv, cam_free,
                      raw=False):
    """Launch the camera half on the current stream: the CG update into
    state (or, raw, the sums back [C, 6])."""
    dev = z.device
    if not z.is_cuda:
        raise ValueError(f"z must be a CUDA tensor, got {dev}")
    C, P = walk_c.n, z.shape[0]
    _check_walk("camera walk", w_c, walk_c, dev)
    check_tensor("z", z, torch.float32, (P, 3), dev)
    for name, t, shape in (("x", state.x, (C, 6)), ("r", state.r, (C, 6)),
                           ("p", state.p, (C, 6)), ("rz", state.rz, (1,)),
                           ("ap", state.ap, (C, 6)), ("part", state.part,
                                                      (C,)),
                           ("hcc_d", hcc_d, (C, 6, 6)),
                           ("d_inv", d_inv, (C, 6, 6)),
                           ("cam_free", cam_free, (C,))):
        check_tensor(name, t, torch.float32, shape, dev)
    check_tensor("count", state.count, torch.int32, (1,), dev)
    back = torch.empty((C, 6), dtype=torch.float32, device=dev) if raw \
        else state.ap
    if C == 0:                  # the entry point would launch nothing
        return back if raw else state
    stream = torch.cuda.current_stream(dev)
    with cuda_build.on_device(dev):
        err = _library().airdos_schur_camera(
            w_c.data_ptr(), walk_c.other.data_ptr(),
            walk_c.offsets.data_ptr(), z.data_ptr(), hcc_d.data_ptr(),
            d_inv.data_ptr(), cam_free.data_ptr(), state.x.data_ptr(),
            state.r.data_ptr(), state.p.data_ptr(), state.rz.data_ptr(),
            back.data_ptr(), state.part.data_ptr(), C, int(raw),
            state.count.data_ptr(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"schur_camera kernel launch failed: cudaError "
                           f"{err}")
    _camera_counter.count(stream.priority)
    return back if raw else state


def schur_point(w_p, walk_p, x, cam_free, hpp_inv, raw=False):
    """z = Hpp^-1 (the sum over each point's edges of Wcp_e^T (x
    cam_free)[cam_e]) [P, 3]; raw: the sums alone.  w_p: walk_rows of the
    point walk.  CUDA tensors go to the kernel, CPU tensors to the plain
    version."""
    if x.is_cuda:
        return schur_point_cuda(w_p, walk_p, x, cam_free, hpp_inv, raw)
    return schur_point_ref(w_p, walk_p, x, cam_free, hpp_inv, raw)


def schur_camera(w_c, walk_c, z, state, hcc_d, d_inv, cam_free, raw=False):
    """One CG iteration's camera half and update, in place into state (the
    state is returned); raw: the sums back = W z [C, 6] alone, state
    untouched.  w_c: walk_rows of the camera walk."""
    if z.is_cuda:
        return schur_camera_cuda(w_c, walk_c, z, state, hcc_d, d_inv,
                                 cam_free, raw)
    return schur_camera_ref(w_c, walk_c, z, state, hcc_d, d_inv, cam_free,
                            raw)
