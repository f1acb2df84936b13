"""The global BA's conjugate-gradient half-steps: two CUDA kernels + their
plain twins.

airdos_tpu's global BA (solvers/global_ba.py:113 ``schur_matvec``, :133
``precond``, :143 ``cg_body``) solves the reduced camera system S dx = b
by preconditioned CG without forming S: each iteration is S p, two
gathers and two scatter-adds over the edge table, and the CG's vector
algebra.  Here an iteration is two launches:

- schur_point (the point half): for each point, the sum over its
  edges of Wcp_e^T (p * cam_free)[cam_e], in the edges' order in the
  point-keyed segment index (``make_segments``), times Hpp^-1: z [P, 3].
- schur_camera (the camera half and the CG update): for each camera,
  back = the sum over its edges of Wcp_e z[pt_e] in the camera-keyed
  index's order, Ap = (Hcc_d xm - back) cam_free + xm (1 - cam_free) with
  xm = p cam_free (global_ba.py:152-159); then, after a grid barrier,
  every block runs the update for its own cameras: alpha, x, r, z = D^-1
  r, r.z, and after a second barrier beta and p, with the 1e-20 guards of
  global_ba.py:174 and :179.

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
and before the update (the camera launch stops before its first grid
barrier): the caller psums them and finishes the iteration itself
(solvers/global_ba.py eagerly, on every rank).  ``matvec`` by
Hpp^-1 and ``cg_update`` are those steps in the kernels' order.

``point_half`` and ``camera_half`` prepare one Gauss-Newton step's
halves: on CUDA tensors a ``PointLaunch`` / ``CameraLaunch``, which checks
every tensor once and then only launches its entry point of
``csrc/ba_global.cu`` on the stream that was current when it was made
(built with nvcc at first use into ``airdos_tpu_torch/_build/``, bound
through ctypes) and counts the launch, by thread and stream priority
too; on CPU tensors the plain versions (any float dtype).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from airdos_tpu_torch.ops import cuda_build
from airdos_tpu_torch.ops.cuda_build import check_tensor
from airdos_tpu_torch.ops.segment_kernels import Segments, segment_sum_ref

LANES = 256            # the dot products' lanes: csrc/ba_global.cu kThreads
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
    """The CG's state, updated in place by ``camera_half``: x, r, p [C,
    6], rz [1]; ap [C, 6] and part [2, C] (each camera's p.Ap, then its
    r.z) are scratch."""
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    ap: torch.Tensor
    part: torch.Tensor


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
                   part=b_red.new_empty(2, C))


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
    "airdos_schur_point": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 2,
    "airdos_schur_camera": [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "airdos_schur_residency": [ctypes.c_void_p],
}
_lib = None                      # the loaded library, once built
_residency = {}                  # device index -> camera blocks the card holds

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


def camera_grid_cap(device: torch.device) -> int:
    """The camera blocks `device` holds at once (its SMs times the blocks
    an SM holds): the cooperative launch's largest grid.  Sets the
    kernel's shared memory there, once a device; raises where the device
    cannot launch a cooperative grid."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    cap = _residency.get(index)
    if cap is None:
        out = (ctypes.c_int * 3)()
        with cuda_build.on_device(torch.device("cuda", index)):
            err = _library().airdos_schur_residency(out)
        if err != 0:
            raise RuntimeError(f"schur_camera residency query failed: "
                               f"cudaError {err}")
        if not out[0] or out[2] < 1:
            raise RuntimeError(f"cuda:{index} cannot launch schur_camera's "
                               f"cooperative grid (cooperative launch "
                               f"{out[0]}, blocks an SM {out[2]})")
        cap = _residency[index] = out[1] * out[2]
    return cap


def _check_walk(name, w, walk: Walk, dev):
    E = w.shape[0]
    check_tensor(f"{name} rows", w, torch.float32, (E, 18), dev)
    check_tensor(f"{name} other", walk.other, torch.int32, (E,), dev)
    check_tensor(f"{name} offsets", walk.offsets, torch.int32,
                 (walk.n + 1,), dev)
    if E * 18 >= 2 ** 31:
        raise ValueError(f"{E} edges exceed the kernels' indexing")
    if w.data_ptr() % 16:
        raise ValueError(f"{name} rows must start on 16 bytes (the "
                         f"kernels' async copies)")


def _on_card(name, t):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")


class PointLaunch:
    """The point half on the card for fixed inputs, checked once: each
    call launches csrc/ba_global.cu's schur_point with x as it then is on
    the stream current at construction, and returns schur_point_ref's z
    (into one buffer, rewritten by the next call) or, raw, its sums (a new
    tensor)."""

    def __init__(self, w_p, walk_p: Walk, x, cam_free, hpp_inv):
        dev = x.device
        C, P = x.shape[0], walk_p.n
        _check_walk("point walk", w_p, walk_p, dev)
        check_tensor("x", x, torch.float32, (C, 6), dev)
        check_tensor("cam_free", cam_free, torch.float32, (C,), dev)
        check_tensor("hpp_inv", hpp_inv, torch.float32, (P, 3, 3), dev)
        if x.data_ptr() % 8:
            raise ValueError("x must start on 8 bytes (the kernel's "
                             "8-byte loads)")
        _on_card("x", x)
        self.w_p, self.walk_p, self.x = w_p, walk_p, x
        self.cam_free, self.hpp_inv = cam_free, hpp_inv
        self.n_points = P
        self.z = torch.empty((P, 3), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev)
        self._stream, self._priority = stream.cuda_stream, stream.priority
        self._on_device = cuda_build.on_device(dev)
        self._fn = _library().airdos_schur_point if P else None
        self._args = (w_p.data_ptr(), walk_p.other.data_ptr(),
                      walk_p.offsets.data_ptr(), x.data_ptr(),
                      cam_free.data_ptr(), hpp_inv.data_ptr(), P,
                      w_p.shape[0])

    def __call__(self, raw=False):
        out = torch.empty_like(self.z) if raw else self.z
        if self._fn is None:        # no point: the kernel launches nothing
            return out
        with self._on_device:
            err = self._fn(*self._args, int(raw), out.data_ptr(),
                           self._stream)
        if err != 0:
            raise RuntimeError(f"schur_point kernel launch failed: cudaError "
                               f"{err}")
        _point_counter.count(self._priority)
        return out


class CameraLaunch:
    """The camera half and the CG update on the card for fixed inputs,
    checked once: each call launches csrc/ba_global.cu's schur_camera on
    z (the point half's buffer, or any [P, 3] tensor, checked then) on the
    stream current at construction; the update goes into state (returned)
    or, raw, the sums back [C, 6] are returned (a new tensor)."""

    def __init__(self, w_c, walk_c: Walk, state: CGState, hcc_d, d_inv,
                 cam_free, n_points: int):
        dev = state.x.device
        C = walk_c.n
        _check_walk("camera walk", w_c, walk_c, dev)
        for name, t, shape in (("x", state.x, (C, 6)), ("r", state.r, (C, 6)),
                               ("p", state.p, (C, 6)), ("rz", state.rz, (1,)),
                               ("ap", state.ap, (C, 6)),
                               ("part", state.part, (2, C)),
                               ("hcc_d", hcc_d, (C, 6, 6)),
                               ("d_inv", d_inv, (C, 6, 6)),
                               ("cam_free", cam_free, (C,))):
            check_tensor(name, t, torch.float32, shape, dev)
        _on_card("x", state.x)
        self.w_c, self.walk_c, self.state = w_c, walk_c, state
        self.hcc_d, self.d_inv, self.cam_free = hcc_d, d_inv, cam_free
        self.n_points, self._dev = n_points, dev
        stream = torch.cuda.current_stream(dev)
        self._stream, self._priority = stream.cuda_stream, stream.priority
        self._on_device = cuda_build.on_device(dev)
        self._fn = None
        if C:
            self._fn = _library().airdos_schur_camera
            self.grid = min(C, camera_grid_cap(dev))
        self._pointer = (w_c.data_ptr(), walk_c.other.data_ptr(),
                         walk_c.offsets.data_ptr())
        self._rest = (hcc_d.data_ptr(), d_inv.data_ptr(),
                      cam_free.data_ptr(), state.x.data_ptr(),
                      state.r.data_ptr(), state.p.data_ptr(),
                      state.rz.data_ptr())
        self._z = None              # the z last checked

    def __call__(self, z, raw=False):
        if z is not self._z:
            check_tensor("z", z, torch.float32, (self.n_points, 3), self._dev)
            self._z = z
        back = torch.empty_like(self.state.ap) if raw else self.state.ap
        if self._fn is None:        # no camera: the kernel launches nothing
            return back if raw else self.state
        with self._on_device:
            err = self._fn(*self._pointer, z.data_ptr(), *self._rest,
                           back.data_ptr(), self.state.part.data_ptr(),
                           self.walk_c.n, self.w_c.shape[0], int(raw),
                           self.grid, self._stream)
        if err != 0:
            raise RuntimeError(f"schur_camera kernel launch failed: cudaError "
                               f"{err}")
        _camera_counter.count(self._priority)
        return back if raw else self.state


def point_half(w_p, walk_p, x, cam_free, hpp_inv):
    """The point half for a Gauss-Newton step's CG: a callable (raw=False)
    -> z = Hpp^-1 (the sum over each point's edges of Wcp_e^T (x
    cam_free)[cam_e]) [P, 3], or raw the sums alone, with x as it is at
    the call.  w_p: walk_rows of the point walk.  CUDA tensors: a
    PointLaunch (raises on what the kernel does not take); CPU tensors:
    the plain version."""
    if x.is_cuda:
        return PointLaunch(w_p, walk_p, x, cam_free, hpp_inv)
    return lambda raw=False: schur_point_ref(w_p, walk_p, x, cam_free,
                                             hpp_inv, raw)


def camera_half(w_c, walk_c, state, hcc_d, d_inv, cam_free, n_points):
    """The camera half and update for a Gauss-Newton step's CG: a callable
    (z, raw=False) -> state, updated in place by one iteration; raw: the
    sums back = W z [C, 6] alone, state untouched.  w_c: walk_rows of the
    camera walk.  CUDA tensors: a CameraLaunch; CPU tensors: the plain
    version."""
    if state.x.is_cuda:
        return CameraLaunch(w_c, walk_c, state, hcc_d, d_inv, cam_free,
                            n_points)
    return lambda z, raw=False: schur_camera_ref(w_c, walk_c, z, state, hcc_d,
                                                 d_inv, cam_free, raw)
