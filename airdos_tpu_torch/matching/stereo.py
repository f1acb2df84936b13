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

Step 3 is ``ops/stereo_sad.stereo_sad``, a kernel launch on the card that
reads the pyramid levels where they lie; its plain version cuts the
windows by gather from zero-padded level stacks (airdos_tpu's
``_sad_windows_gather``).  Steps 1-2 and 4 are eager torch.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from airdos_tpu_torch.ops.hamming_kernels import hamming_matrix
from airdos_tpu_torch.ops.stereo_sad import _take, stereo_sad
# exported here as airdos_tpu.matching.stereo exports it
from airdos_tpu_torch.ops.stereo_sad import stack_pyramid  # noqa: F401

TH_HIGH = 100
TH_LOW = 50
TH_ORB = (TH_HIGH + TH_LOW) // 2   # 75
BIG = 1 << 10


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
    dev = xy_l.device
    uL, vL = xy_l[:, 0], xy_l[:, 1]
    uR, vR = xy_r[:, 0], xy_r[:, 1]
    # float32 like airdos_tpu, which passes bf and baseline as f32 scalars
    max_d = float(np.float32(bf) / np.float32(baseline))

    # ---- gating + Hamming (dense) -----------------------------------
    r_band = 2.0 * scale_factors[oct_r]
    row_ok = torch.abs(vL[:, None] - vR[None, :]) <= r_band[None, :]
    oct_ok = torch.abs(oct_l[:, None] - oct_r[None, :]) <= 1
    disp = uL[:, None] - uR[None, :]
    disp_ok = (disp >= 0.0) & (disp <= max_d)
    ok = row_ok & oct_ok & disp_ok & valid_l[:, None] & valid_r[None, :]

    D = hamming_matrix(desc_l, desc_r)
    D = torch.where(ok, D, torch.full_like(D, BIG))
    best_r = torch.argmin(D, dim=1)
    best_dist = _take(D, best_r)
    # mutual consistency: the matched right keypoint's own best left
    # keypoint must be this one
    best_l_of_r = torch.argmin(D, dim=0)
    mutual = best_l_of_r[best_r] == torch.arange(xy_l.shape[0], device=dev)
    # ambiguity rejection: a second right candidate at a clearly different
    # u that is nearly as good makes the disparity unreliable
    far_u = torch.abs(uR[None, :] - uR[best_r][:, None]) > 1.5
    D2 = torch.where(far_u, D, torch.full_like(D, BIG))
    second = torch.amin(D2, dim=1)
    unambiguous = best_dist.to(torch.float32) < \
        0.9 * torch.clamp(second, max=256).to(torch.float32)
    cand_ok = (best_dist < TH_ORB) & mutual & unambiguous

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
