"""BoW-guided descriptor matching (SearchByBoW).

Rebuild of ORBmatcher::SearchByBoW (reference src/ORBmatcher.cc:159-288
KF<->Frame, 522-655 KF<->KF) as airdos_tpu/matching/bow_match.py computes
it: candidates restricted to features sharing the same vocabulary node at
the feature-grouping level, best Hamming with NN-ratio and
rotation-histogram checks, then each feature of set 2 keeps its best
claimant.  The node gate, the distances, best and second, the ratio,
the rotation histogram and the uniqueness are one
``ops/match_kernels.match_rows`` call in bow mode with the resolve: one
kernel launch on the card, where no N1 x N2 matrix is formed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from airdos_tpu_torch.ops.match_kernels import (BOW, MatchCols, MatchRows,
                                                match_rows)

TH_LOW = 50


class BowMatches(NamedTuple):
    idx2: torch.Tensor        # [N1] best match in set 2 (-1 none)
    n_matches: torch.Tensor
    idx1_of_2: torch.Tensor   # [N2] winning feature in set 1 (-1)


def match_by_bow(desc1, nodes1, valid1, ang1,
                 desc2, nodes2, valid2, ang2,
                 nn_ratio: float = 0.7,
                 check_rotation: bool = True) -> BowMatches:
    """Features of two images with per-feature vocabulary node ids."""
    rm = match_rows(BOW, MatchRows(desc1, nodes1, valid1),
                    MatchCols(desc2, nodes2, valid2), th=TH_LOW - 1,
                    ratio=nn_ratio, resolve=True,
                    angles=(ang1, ang2) if check_rotation else None,
                    check=False)
    return BowMatches(idx2=rm.feat_idx, n_matches=rm.n,
                      idx1_of_2=rm.point_of_feat)
