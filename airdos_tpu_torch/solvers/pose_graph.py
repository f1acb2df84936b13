"""Essential-graph (Sim3 pose-graph) optimization.

Rebuild of Optimizer::OptimizeEssentialGraph (reference
src/Optimizer.cc:2225-2473) as airdos_tpu/solvers/pose_graph.py computes
it: vertices are all keyframes as Sim3 (scale fixed to 1 for stereo);
edges are the loop edges, spanning-tree edges, high-covisibility edges
(>= 100 shared points) and previous loop edges, with relative-Sim3
measurements from the poses at graph-build time; 20 LM iterations.  Map
points are corrected afterwards through their reference keyframes (by
the caller).

- Per-edge residual e = log_sim3(S_meas * S_i * S_j^-1) with Jacobians
  over the two 7-dim perturbations by reverse-mode autograd
  (``edge_jacobians``; airdos_tpu: ``jax.jacfwd`` under ``jax.vmap``).
- The dense 7K x 7K system collects each edge's 14 x 14 J^T W J block and
  14-vector at positions that repeat (a vertex's diagonal block gathers
  every edge it is in).  airdos_tpu scatter-adds them
  (``H.at[gidx, gidx].add``); here the entries are summed per distinct
  position in edge order by one ``segment_sum`` launch a step
  (``make_compact_segments``, built once a call: the edge table is fixed
  across the steps), as the human BA does, with no float atomics.
- The system is solved by Cholesky (``cho_solve_dense``); the loop never
  reads a device value on the host.
"""
from __future__ import annotations

import torch

from airdos_tpu_torch.geometry.se3 import (sim3_compose, sim3_inverse,
                                           sim3_log, so3_exp)
from airdos_tpu_torch.ops.segment_kernels import (make_compact_segments,
                                                  segment_sum)
from airdos_tpu_torch.solvers.human_ba import scatter_keys, scatter_values
from airdos_tpu_torch.solvers.smallmat import cho_solve_dense


def _edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """e = log_sim3( S_meas * S_i * S_j^-1 ), 7-dim."""
    Rinv, tinv, sinv = sim3_inverse(Rj, tj, sj)
    Rij, tij, sij = sim3_compose(Ri, ti, si, Rinv, tinv, sinv)
    return sim3_log(*sim3_compose(Rm, tm, sm, Rij, tij, sij))


def _perturb(R, t, s, xi):
    return so3_exp(xi[:, 3:6]) @ R, t + xi[:, :3], s * torch.exp(xi[:, 6])


def _residual_fn(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
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
        e = _residual_fn(xi[:, :7], xi[:, 7:], *args).reshape(7, E, 7)
        picked = torch.diagonal(e, dim1=0, dim2=2)        # [E, 7]: e[k, :, k]
        J = torch.autograd.grad(picked.sum(), xi)[0]      # [7E, 14]
    J = J.reshape(7, E, 14).transpose(0, 1)               # [E, 7, 14]
    return e[0].detach(), J[..., :7], J[..., 7:]


def optimize_essential_graph(
        kf_R, kf_t, kf_s,          # [K, ...] current Sim3 vertex estimates
        kf_fixed,                  # [K] bool (the loop KF is fixed)
        e_i, e_j,                  # [E] vertex indices
        e_Rm, e_tm, e_sm,          # [E, ...] relative measurements
        e_valid,                   # [E]
        n_iters: int = 20, fix_scale: bool = True, step_hook=None):
    """step_hook, when given, is called before each Gauss-Newton step (the
    online loop closer waits there while tracking is in its frame)."""
    K = kf_R.shape[0]
    dtype, dev = kf_t.dtype, kf_t.device
    D = 7 * K
    e_i = e_i.to(torch.int64)
    e_j = e_j.to(torch.int64)
    w = e_valid.to(dtype)
    ar7 = torch.arange(7, device=dev)
    gidx = torch.cat([e_i[:, None] * 7 + ar7, e_j[:, None] * 7 + ar7], dim=1)
    # the scatter's distinct positions, once a call (one host read)
    keys, keep = scatter_keys((gidx,), (e_valid,), D)
    seg, pos = make_compact_segments(keys, keep)

    free = ~torch.repeat_interleave(kf_fixed, 7)
    if fix_scale:
        free = free & ((torch.arange(D, device=dev) % 7) != 6)
    freef = free.to(dtype)
    fixed_diag = torch.diag(1.0 - freef)
    eyeD = torch.eye(D, dtype=dtype, device=dev)

    zero = torch.zeros((e_i.shape[0], 7), dtype=dtype, device=dev)

    def residuals(R, t, s, jac: bool):
        args = (R[e_i], t[e_i], s[e_i], R[e_j], t[e_j], s[e_j],
                e_Rm, e_tm, e_sm)
        return edge_jacobians(*args) if jac else \
            _residual_fn(zero, zero, *args)

    def gn_step(R, t, s, lam):
        e, Ji, Jj = residuals(R, t, s, True)
        vals = scatter_values(((torch.cat([Ji, Jj], dim=2), w, e),))
        Hb = torch.zeros(D * D + D, dtype=dtype, device=dev)
        Hb[pos] = segment_sum(vals, seg)[:, 0]
        H = Hb[:D * D].reshape(D, D)
        b = Hb[D * D:]
        H = H * freef[:, None] * freef[None, :] + fixed_diag
        b = b * freef
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-6 * eyeD
        dx = (cho_solve_dense(Hd, b) * freef).reshape(K, 7)
        return (so3_exp(dx[:, 3:6]) @ R, t + dx[:, :3],
                s * torch.exp(dx[:, 6]))

    def cost(R, t, s):
        e = residuals(R, t, s, False)
        return torch.sum(torch.sum(e * e, dim=1) * w)

    R, t, s = kf_R, kf_t, kf_s
    lam = torch.tensor(1e-6, dtype=dtype, device=dev)
    f_prev = cost(R, t, s)
    for _ in range(n_iters):
        if step_hook is not None:
            step_hook()
        Rn, tn, sn = gn_step(R, t, s, lam)
        f_new = cost(Rn, tn, sn)
        better = f_new < f_prev
        R = torch.where(better, Rn, R)
        t = torch.where(better, tn, t)
        s = torch.where(better, sn, s)
        lam = torch.where(better, lam * 0.3, lam * 8.0)
        f_prev = torch.where(better, f_new, f_prev)
    return R, t, s
