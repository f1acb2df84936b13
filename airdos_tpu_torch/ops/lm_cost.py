"""The LM cost of one edge family in a fixed order: the plain torch sum
that the BA kernels' cost-sum modes are held to.

airdos_tpu's local and human BAs decide each Levenberg-Marquardt step by
the cost sum(where(isfinite(rho), rho, 1e30) * active) of every edge
family (solvers/local_ba.py:176-182, solvers/human_ba.py:223-243), summed
in XLA's order.  Here the order is fixed, so a kernel and this plain
version agree bit for bit and a sum on the card is the same from run to
run:

- 1024 partial sums: partial j adds the terms j, j + 1024, j + 2048, ...
  in sequence, from 0;
- a halving tree over the partials: j + 512, then 256, ..., 1.

``lm_cost_ref`` pads the terms with zeros to a multiple of 1024, adds the
[n / 1024, 1024] rows in sequence and halves ten times.  The static
family's sum is static_edge_blocks' cost-sum mode (ops/ba_static.py,
csrc/ba_static.cu) and the human families' human_edge_blocks' (ops/
ba_human.py, csrc/ba_human.cu), each in this order; no kernel of its own
computes it.  On a mesh each rank's sum is psum-added where airdos_tpu
psums.
"""
from __future__ import annotations

import torch

PARTIALS = 1024                  # the partial sums, one a kernel thread
NON_FINITE = 1e30                # the cost of a non-finite edge


def lm_cost_ref(rho: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Plain torch version: the 0-dim float32 sum of
    where(isfinite(rho), rho, 1e30) * active in the fixed order."""
    v = torch.where(torch.isfinite(rho), rho,
                    torch.full_like(rho, NON_FINITE)) * active
    m = -(-v.shape[0] // PARTIALS)
    v = torch.cat([v, v.new_zeros(m * PARTIALS - v.shape[0])])
    rows = v.reshape(m, PARTIALS)
    acc = v.new_zeros(PARTIALS)
    for i in range(m):
        acc = acc + rows[i]
    half = PARTIALS // 2
    while half:
        acc = acc[:half] + acc[half:2 * half]
        half //= 2
    return acc[0]
