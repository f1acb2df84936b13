"""The essential graph's Sim(3) edge system: a CUDA kernel + its plain
twin.

airdos_tpu's essential graph (solvers/pose_graph.py:27 ``_edge_residual``,
:59 ``edge_system``) gives each edge the residual e = log_sim3(S_m S_i
S_j^-1) and its 7 x 14 Jacobian with respect to the perturbations of its
two vertices (R <- exp(xi[3:6]) R, t <- t + xi[:3], s <- s exp(xi[6])) by
``jax.jacfwd`` under ``vmap``, then scatter-adds J^T W J and -J^T W e into
the dense 7K x 7K system.  ``sim3_edges`` computes, for every edge, either

- (Gauss-Newton mode) its 14 x 14 J^T w J and 14-vector -J^T w e in
  ``solvers/human_ba.py`` ``scatter_values``' layout (every edge's 196
  entries row-major, then every edge's 14): the column the compact
  ``segment_sum`` assembles H and b from, or
- (cost mode) sum_e w_e |e_e|^2, the LM cost.

- ``sim3_edges_ref`` is the plain version: the eager composition the
  kernel replaced, ``edge_jacobians`` (one reverse-mode autograd pass
  over the edges repeated seven times) and ``scatter_values``, or the
  residuals' ``torch.sum``.
- ``sim3_edges`` on CUDA tensors launches ``csrc/sim3_edges.cu`` on the
  calling thread's current stream (built with nvcc at first use into
  ``airdos_tpu_torch/_build/``, bound through ctypes) or raises, and
  counts the launch, by thread and stream priority too; on CPU tensors it
  runs the plain version.  The kernel takes the Jacobians in forward
  mode, as jacfwd does: each of 14 lanes carries one perturbation
  direction as a dual number through the residual, following the branch
  its value takes (so3_log near 0 and near pi, the three regimes of
  Sim(3)'s V).  It sums in other orders than the plain version, which
  it matches within SYSTEM_RTOL (csrc/sim3_edges.cu says why).
"""
from __future__ import annotations

import ctypes

import torch

from airdos_tpu_torch.geometry.se3 import (sim3_compose, sim3_inverse,
                                           sim3_log, so3_exp)
from airdos_tpu_torch.ops import cuda_build
from airdos_tpu_torch.ops.cuda_build import check_tensor
from airdos_tpu_torch.solvers.human_ba import scatter_values

# the kernel against the plain version (float32 Jacobians by forward
# tangents against reverse-mode products, summed in other orders): the
# cost within this share of itself; an edge's J^T J within it of its
# largest entry of the plain version in float64, and its J^T e within it
# of |J| |e| plus F32_FLOOR of |J| times its translation scale (the
# rounding of a float32 residual), or no farther from float64 than twice
# the float32 plain version is (``edge_gaps``, ``held``)
SYSTEM_RTOL = 1e-4
F32_FLOOR = 16 * 2.0 ** -24
ENTRIES = 14 * 14 + 14          # an edge's entries in the GN column


def _edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """e = log_sim3( S_meas * S_i * S_j^-1 ), 7-dim."""
    Rinv, tinv, sinv = sim3_inverse(Rj, tj, sj)
    Rij, tij, sij = sim3_compose(Ri, ti, si, Rinv, tinv, sinv)
    return sim3_log(*sim3_compose(Rm, tm, sm, Rij, tij, sij))


def _perturb(R, t, s, xi):
    return so3_exp(xi[:, 3:6]) @ R, t + xi[:, :3], s * torch.exp(xi[:, 6])


def residual_fn(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """Residuals [E, 7] of all edges, vertex i perturbed by xi_i [E, 7] and
    vertex j by xi_j."""
    return _edge_residual(*_perturb(Ri, ti, si, xi_i),
                          *_perturb(Rj, tj, sj, xi_j), Rm, tm, sm)


def edge_jacobians(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """Per edge (leading dimension E): residual e [E, 7] and the Jacobians
    Ji, Jj [E, 7, 7] with respect to the perturbations of vertices i and j
    at zero, in one reverse-mode pass.  The edges are repeated seven times
    (7E rows, each with its own 14 perturbation parameters); copy k keeps
    only residual component k, so the gradient of their sum with respect
    to copy k's parameters is row k of every edge's Jacobian.  (airdos_tpu
    takes jax.jacfwd under jax.vmap.  torch.func's forward mode runs every
    op that meets a Python float through a Python decomposition, and
    under vmap promotes a 0-dim operand to float64; seven backward passes,
    or one batched over the components with ``is_grads_batched``, made the
    essential graph take seconds a solve on the card (PERF.md, section
    6).  Reverse mode matches jacfwd to float32 rounding.)"""
    E = ti.shape[0]
    args = [x.repeat((7,) + (1,) * (x.dim() - 1))
            for x in (Ri, ti, si, Rj, tj, sj, Rm, tm, sm)]
    xi = torch.zeros((7 * E, 14), dtype=ti.dtype, device=ti.device,
                     requires_grad=True)
    with torch.enable_grad():
        e = residual_fn(xi[:, :7], xi[:, 7:], *args).reshape(7, E, 7)
        picked = torch.diagonal(e, dim1=0, dim2=2)        # [E, 7]: e[k, :, k]
        J = torch.autograd.grad(picked.sum(), xi)[0]      # [7E, 14]
    J = J.reshape(7, E, 14).transpose(0, 1)               # [E, 7, 14]
    return e[0].detach(), J[..., :7], J[..., 7:]


def _edge_args(R, t, s, e_i, e_j, Rm, tm, sm):
    i, j = e_i.long(), e_j.long()
    return (R[i], t[i], s[i], R[j], t[j], s[j], Rm, tm, sm)


def residuals(R, t, s, e_i, e_j, Rm, tm, sm):
    """Every edge's residual [E, 7] at the vertices (no perturbation)."""
    zero = torch.zeros((e_i.shape[0], 7), dtype=t.dtype, device=t.device)
    return residual_fn(zero, zero, *_edge_args(R, t, s, e_i, e_j, Rm, tm,
                                               sm))


def sim3_edges_ref(R, t, s, e_i, e_j, Rm, tm, sm, w, cost: bool = False):
    """Plain version.  R [K, 3, 3], t [K, 3], s [K]: the vertices; e_i,
    e_j [E] int: each edge's vertices; Rm [E, 3, 3], tm [E, 3], sm [E]:
    its measurement; w [E]: its weight.  Gauss-Newton mode: the column
    [E * ENTRIES, 1] of scatter_values; cost mode: sum w |e|^2 (0-dim)."""
    if cost:
        e = residuals(R, t, s, e_i, e_j, Rm, tm, sm)
        return torch.sum(torch.sum(e * e, dim=1) * w)
    e, Ji, Jj = edge_jacobians(*_edge_args(R, t, s, e_i, e_j, Rm, tm, sm))
    return scatter_values(((torch.cat([Ji, Jj], dim=2), w, e),))


def edge_gaps(got, want, R, t, s, e_i, e_j, Rm, tm, sm, w):
    """How far two Gauss-Newton columns of the same edges are apart, per
    edge [E], as shares of its tolerance: its J^T J entries' gap over
    SYSTEM_RTOL times its largest J^T J entry, and its J^T e entries' gap
    over sqrt(w) sqrt(its largest J^T J diagonal entry) (a bound on |J| w)
    times SYSTEM_RTOL |e| + F32_FLOOR |e|_t, the residual's translation
    scale |e| + |tm| + sm (|t_i| + si / sj |t_j|): a float32 residual is
    known to a few units of 2^-24 of that scale, whatever its own size
    (an edge far from the origin whose measurement matches its vertices
    has e ~ 0 in float64 and float32 noise in float32)."""
    E = e_i.shape[0]
    H, Hw = (x[:E * 196, 0].reshape(E, 14, 14) for x in (got, want))
    b, bw = (x[E * 196:, 0].reshape(E, 14) for x in (got, want))
    e = residuals(R, t, s, e_i, e_j, Rm, tm, sm)
    i, j = e_i.long(), e_j.long()
    e_norm = torch.linalg.norm(e, dim=1)
    scale = e_norm + torch.linalg.norm(tm, dim=1) + sm * (
        torch.linalg.norm(t[i], dim=1)
        + s[i] / s[j] * torch.linalg.norm(t[j], dim=1))
    tiny = torch.finfo(Hw.dtype).tiny
    h_tol = (SYSTEM_RTOL * Hw.abs().amax((1, 2))).clamp(min=tiny)
    j_norm = (torch.diagonal(Hw, dim1=1, dim2=2).amax(1).clamp(min=0)
              * w.clamp(min=0)).sqrt()
    b_tol = (j_norm * (SYSTEM_RTOL * e_norm + F32_FLOOR * scale)).clamp(
        min=tiny)
    return ((H - Hw).abs().amax((1, 2)) / h_tol,
            (b - bw).abs().amax(1) / b_tol)


def system_gap(got, want, R, t, s, e_i, e_j, Rm, tm, sm, w):
    """edge_gaps' largest (J^T J, J^T e) shares over the edges."""
    return tuple(float(g.max()) for g in edge_gaps(
        got, want, R, t, s, e_i, e_j, Rm, tm, sm, w))


# ------------------------------------------------------------------ kernel

_SOURCE = cuda_build.CSRC / "sim3_edges.cu"
_SIGNATURES = {
    "airdos_sim3_edges": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2
    + [ctypes.c_void_p],
}
_lib = None                      # the loaded library, once built

_counter = cuda_build.LaunchCounter()


def launches() -> int:
    """sim3_edges launches since the last reset_launches()."""
    return _counter.total


def launch_tally() -> dict:
    """{("sim3_edges", thread name, stream priority): launches} since the
    last reset_launches()."""
    return {("sim3_edges",) + key: n for key, n in _counter.tally().items()}


def reset_launches() -> None:
    _counter.reset()


def build():
    """Compile csrc/sim3_edges.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def sim3_edges_cuda(R, t, s, e_i, e_j, Rm, tm, sm, w, cost: bool = False):
    """Launch the kernel on the current stream: one launch."""
    global _lib
    dev = t.device
    if not t.is_cuda:
        raise ValueError(f"t must be a CUDA tensor, got {dev}")
    K, E = t.shape[0], e_i.shape[0]
    f32, i32 = torch.float32, torch.int32
    for name, x, dtype, shape in (
            ("R", R, f32, (K, 3, 3)), ("t", t, f32, (K, 3)),
            ("s", s, f32, (K,)), ("e_i", e_i, i32, (E,)),
            ("e_j", e_j, i32, (E,)), ("Rm", Rm, f32, (E, 3, 3)),
            ("tm", tm, f32, (E, 3)), ("sm", sm, f32, (E,)),
            ("w", w, f32, (E,))):
        check_tensor(name, x, dtype, shape, dev)
    if E * ENTRIES >= 2 ** 31:
        raise ValueError(f"{E} edges exceed the kernel's indexing")
    out = torch.empty((1,) if cost else (E * ENTRIES, 1), dtype=f32,
                      device=dev)
    if E == 0 and not cost:     # the entry point would launch nothing
        return out
    if _lib is None:
        _lib = cuda_build.library(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(dev)
    with cuda_build.on_device(dev):
        err = _lib.airdos_sim3_edges(
            R.data_ptr(), t.data_ptr(), s.data_ptr(), e_i.data_ptr(),
            e_j.data_ptr(), Rm.data_ptr(), tm.data_ptr(), sm.data_ptr(),
            w.data_ptr(), out.data_ptr(), E, int(cost),
            stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"sim3_edges kernel launch failed: cudaError "
                           f"{err}")
    _counter.count(stream.priority)
    return out.reshape(()) if cost else out


def sim3_edges(R, t, s, e_i, e_j, Rm, tm, sm, w, cost: bool = False):
    """The edges' Gauss-Newton column (scatter_values' layout, [E *
    ENTRIES, 1]) or, with cost, their sum w |e|^2 (0-dim).  CUDA tensors go
    to the kernel, CPU tensors to the plain version."""
    if t.is_cuda:
        return sim3_edges_cuda(R, t, s, e_i, e_j, Rm, tm, sm, w, cost)
    return sim3_edges_ref(R, t, s, e_i, e_j, Rm, tm, sm, w, cost)


def held(got, R, t, s, e_i, e_j, Rm, tm, sm, w):
    """A Gauss-Newton column `got` of the kernel held to the plain version
    in float64: (whether it holds, its largest shares of edge_gaps'
    tolerances, the float32 plain version's), each (J^T J, J^T e).  It
    holds where each edge's share is at most 1 or twice the float32 plain
    version's at that edge: where a residual's small rotation puts Sim(3)'s
    V (geometry/se3.py _sim3_V's closed forms of 1 - cos and theta - sin)
    in float32 cancellation, both float32 versions are farther than
    SYSTEM_RTOL from float64."""
    args = (R, t, s, e_i, e_j, Rm, tm, sm, w)
    f64 = [a.double() if a.is_floating_point() else a for a in args]
    want = sim3_edges_ref(*f64)
    mine = edge_gaps(got.double(), want, *f64)
    plain = edge_gaps(sim3_edges_ref(*args).double(), want, *f64)
    ok = all(bool((g <= torch.clamp(2.0 * p, min=1.0)).all())
             for g, p in zip(mine, plain))
    return (ok, tuple(float(g.max()) for g in mine),
            tuple(float(p.max()) for p in plain))
