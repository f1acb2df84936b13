"""Essential-graph (Sim3 pose-graph) optimization.

Rebuild of Optimizer::OptimizeEssentialGraph (reference
src/Optimizer.cc:2225-2473) as airdos_tpu/solvers/pose_graph.py computes
it: vertices are all keyframes as Sim3 (scale fixed to 1 for stereo);
edges are the loop edges, spanning-tree edges, high-covisibility edges
(>= 100 shared points) and previous loop edges, with relative-Sim3
measurements from the poses at graph-build time; 20 LM iterations.  Map
points are corrected afterwards through their reference keyframes (by
the caller).

- Per-edge residual e = log_sim3(S_meas * S_i * S_j^-1), its Jacobians
  over the two 7-dim perturbations and the edge's 14 x 14 J^T W J block
  and 14-vector, or the LM cost: ``ops/pose_graph_kernels.sim3_edges``,
  one launch a Gauss-Newton step and one a cost (forward tangents, as
  airdos_tpu's ``jax.jacfwd`` under ``jax.vmap``; on the CPU its plain
  version, one reverse-mode autograd pass, ``edge_jacobians``).
- The dense 7K x 7K system collects each edge's block and vector at
  positions that repeat (a vertex's diagonal block gathers every edge it
  is in).  airdos_tpu scatter-adds them (``H.at[gidx, gidx].add``); here
  the entries are summed per distinct position in edge order by one
  ``segment_sum`` launch a step (``make_compact_segments``, built once a
  call: the edge table is fixed across the steps), as the human BA does,
  with no float atomics.
- The system is solved by Cholesky (``cho_solve_dense``); the loop never
  reads a device value on the host.
"""
from __future__ import annotations

import torch

from airdos_tpu_torch.geometry.se3 import so3_exp
from airdos_tpu_torch.ops.pose_graph_kernels import (  # noqa: F401
    edge_jacobians, sim3_edges)
from airdos_tpu_torch.ops.segment_kernels import (make_compact_segments,
                                                  segment_sum)
from airdos_tpu_torch.solvers.human_ba import scatter_keys
from airdos_tpu_torch.solvers.smallmat import cho_solve_dense


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
    e_i = e_i.to(torch.int32).contiguous()
    e_j = e_j.to(torch.int32).contiguous()
    e_Rm, e_tm, e_sm = (x.contiguous() for x in (e_Rm, e_tm, e_sm))
    w = e_valid.to(dtype)
    ar7 = torch.arange(7, device=dev)
    gidx = torch.cat([e_i[:, None].long() * 7 + ar7,
                      e_j[:, None].long() * 7 + ar7], dim=1)
    # the scatter's distinct positions, once a call (one host read)
    keys, keep = scatter_keys((gidx,), (e_valid,), D)
    seg, pos = make_compact_segments(keys, keep)

    free = ~torch.repeat_interleave(kf_fixed, 7)
    if fix_scale:
        free = free & ((torch.arange(D, device=dev) % 7) != 6)
    freef = free.to(dtype)
    fixed_diag = torch.diag(1.0 - freef)
    eyeD = torch.eye(D, dtype=dtype, device=dev)

    def edges(R, t, s, cost: bool):
        return sim3_edges(R, t, s, e_i, e_j, e_Rm, e_tm, e_sm, w, cost)

    def gn_step(R, t, s, lam):
        vals = edges(R, t, s, False)
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
        return edges(R, t, s, True)

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
