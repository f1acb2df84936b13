"""Left-right stereo keypoint matching with sub-pixel refinement.

Behavioral rebuild of Frame::ComputeStereoMatches (reference
src/Frame.cc:829-1003), in airdos_tpu's dense form:

1. candidate gating: same row band (|vL - vR| <= 2 * scale[octave_R]),
   octave within +-1, disparity in [0, bf / baseline];
2. best Hamming match per left keypoint (accept < 75), mutual and
   unambiguous;
3. sub-pixel refinement: 11x11 centre-subtracted L1 SAD slid +-5 px on the
   unblurred level image of the left keypoint, parabola fit;
4. median-based outlier cut: reject SAD >= 1.5 * 1.4 * median.

Steps 1-2 are one ``ops/match_kernels.match_rows`` call in stereo mode
(a kernel launch on the card that forms no [N, N] matrix: gate,
distances, best, far-u second, ratio and mutual check).  Step 3 is
``ops/stereo_sad.stereo_sad``, a kernel launch on the card that reads
the pyramid levels where they lie; its plain version cuts the windows by
gather from zero-padded level stacks (airdos_tpu's
``_sad_windows_gather``).  Step 4 is eager torch.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from airdos_tpu_torch.ops.match_kernels import (STEREO, MatchCols,
                                                MatchRows, match_rows)
from airdos_tpu_torch.ops.stereo_sad import stereo_sad
# exported here as airdos_tpu.matching.stereo exports it
from airdos_tpu_torch.ops.stereo_sad import stack_pyramid  # noqa: F401

TH_HIGH = 100
TH_LOW = 50
TH_ORB = (TH_HIGH + TH_LOW) // 2   # 75


class StereoMatches(NamedTuple):
    u_right: torch.Tensor     # [N] float32, -1 if unmatched
    depth: torch.Tensor       # [N] float32, -1 if unmatched
    best_right: torch.Tensor  # [N] int64 matched right kp index (-1 invalid)


def stereo_match(xy_l, oct_l, desc_l, valid_l,
                 xy_r, oct_r, desc_r, valid_r,
                 pyr_l, pyr_r, level_widths, scale_factors,
                 bf: float, baseline: float) -> StereoMatches:
    """xy in level-0 coords; pyr_* are the two images' pyramid levels
    (ops/pyramid.Pyramid.images); level_widths [L] int64 actual widths;
    scale_factors [L] float32."""
    # float32 like airdos_tpu, which passes bf and baseline as f32 scalars
    max_d = float(np.float32(bf) / np.float32(baseline))

    # ---- gating + Hamming, best, mutual and unambiguous ---------------
    # the right keypoint's row band is 2 * scale[octave]; a second right
    # candidate at a clearly different u (> 1.5 px) that is nearly as good
    # (best >= 0.9 * min(second, 256)) makes the disparity unreliable; the
    # matched right keypoint's own best left keypoint must be this one
    rm = match_rows(STEREO, MatchRows(desc_l, oct_l, valid_l, xy_l[:, 0],
                                      xy_l[:, 1]),
                    MatchCols(desc_r, oct_r, valid_r, xy_r[:, 0], xy_r[:, 1],
                              2.0 * scale_factors[oct_r]),
                    th=TH_ORB - 1, ratio=0.9, max_d=max_d, check=False)
    best_r, cand_ok = rm.best, rm.has

    # ---- sub-pixel SAD (ops/stereo_sad: a kernel launch on the card) --
    best_sad, best_u_r, disparity, accept = stereo_sad(
        xy_l, oct_l, valid_l, xy_r, best_r, cand_ok, pyr_l, pyr_r,
        level_widths, scale_factors, max_d)

    # ---- median SAD outlier cut -------------------------------------
    n_acc = torch.sum(accept)
    sad_sorted = torch.sort(torch.where(accept, best_sad,
                                        torch.full_like(best_sad, float("inf")))).values
    median = sad_sorted[torch.clamp(n_acc // 2, 0, best_sad.shape[0] - 1)]
    accept = accept & (best_sad < 1.5 * 1.4 * median)

    neg = torch.full_like(disparity, -1.0)
    depth = torch.where(accept, bf / disparity, neg)
    u_right = torch.where(accept, best_u_r, neg)
    best_right = torch.where(accept, best_r, torch.full_like(best_r, -1))
    return StereoMatches(u_right=u_right, depth=depth, best_right=best_right)
