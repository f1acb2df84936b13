"""BoW-guided descriptor matching (SearchByBoW).

Rebuild of ORBmatcher::SearchByBoW (reference src/ORBmatcher.cc:159-288
KF<->Frame, 522-655 KF<->KF) as airdos_tpu/matching/bow_match.py computes
it: candidates restricted to features sharing the same vocabulary node at
the feature-grouping level (one equality mask over the dense N1 x N2
Hamming matrix), best Hamming with NN-ratio and rotation-histogram checks,
then each feature of set 2 keeps its best claimant.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from airdos_tpu_torch.matching.projection import (_resolve_unique,
                                                  _rotation_consistency)
from airdos_tpu_torch.ops.hamming_kernels import hamming_matrix

TH_LOW = 50
BIG = 1 << 10


class BowMatches(NamedTuple):
    idx2: torch.Tensor        # [N1] best match in set 2 (-1 none)
    n_matches: torch.Tensor
    idx1_of_2: torch.Tensor   # [N2] winning feature in set 1 (-1)


def match_by_bow(desc1, nodes1, valid1, ang1,
                 desc2, nodes2, valid2, ang2,
                 nn_ratio: float = 0.7,
                 check_rotation: bool = True) -> BowMatches:
    """Features of two images with per-feature vocabulary node ids."""
    N1 = desc1.shape[0]
    N2 = desc2.shape[0]
    same_node = nodes1[:, None] == nodes2[None, :]
    ok = same_node & valid1[:, None] & valid2[None, :] & \
        (nodes1 >= 0)[:, None] & (nodes2 >= 0)[None, :]
    D = hamming_matrix(desc1, desc2)
    D = torch.where(ok, D, torch.full_like(D, BIG))
    best = torch.argmin(D, dim=1)
    bdist = torch.gather(D, 1, best[:, None])[:, 0]
    D2 = D.clone()
    D2[torch.arange(N1, device=D.device), best] = BIG
    sdist = torch.min(D2, dim=1).values
    has = (bdist < TH_LOW) & \
        (bdist.to(torch.float32) < nn_ratio * sdist.to(torch.float32))
    if check_rotation:
        has = _rotation_consistency(ang1, ang2[best], has)
    idx2, idx1_of_2, n = _resolve_unique(best, bdist, has, N2)
    return BowMatches(idx2=idx2, n_matches=n, idx1_of_2=idx1_of_2)
