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

The SAD windows are cut by gather (airdos_tpu's ``_sad_windows_gather``).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from airdos_tpu_torch.ops.hamming_kernels import hamming_matrix

TH_HIGH = 100
TH_LOW = 50
TH_ORB = (TH_HIGH + TH_LOW) // 2   # 75
SAD_W = 5                          # half window (11x11)
SAD_L = 5                          # slide range
BIG = 1 << 10


def stack_pyramid(images: Sequence[torch.Tensor]) -> torch.Tensor:
    """Pad per-level images into one [L, H0, W0] stack (zeros outside) so a
    per-keypoint level index can gather windows from any level."""
    h0, w0 = images[0].shape
    return torch.stack([F.pad(im, (0, w0 - im.shape[1], 0, h0 - im.shape[0]))
                        for im in images], dim=0)


class StereoMatches(NamedTuple):
    u_right: torch.Tensor     # [N] float32, -1 if unmatched
    depth: torch.Tensor       # [N] float32, -1 if unmatched
    best_right: torch.Tensor  # [N] int64 matched right kp index (-1 invalid)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[i, idx[i]] for a 2-D x."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


def stereo_match(xy_l, oct_l, desc_l, valid_l,
                 xy_r, oct_r, desc_r, valid_r,
                 pyr_l, pyr_r, level_widths, scale_factors,
                 bf: float, baseline: float) -> StereoMatches:
    """xy in level-0 coords; pyr_* are [L, H, W] stacks from stack_pyramid;
    level_widths [L] int64 actual widths; scale_factors [L] float32."""
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

    # ---- sub-pixel SAD ----------------------------------------------
    inv_scale = 1.0 / scale_factors[oct_l]
    su_l = torch.round(uL * inv_scale).to(torch.int64)
    sv_l = torch.round(vL * inv_scale).to(torch.int64)
    uR0 = uR[best_r]
    su_r0 = torch.round(uR0 * inv_scale).to(torch.int64)

    lvl_w = level_widths[oct_l]
    in_bounds = (su_r0 + SAD_L - SAD_W >= 0) & \
        (su_r0 + SAD_L + SAD_W + 1 < lvl_w)

    h0, w0 = pyr_l.shape[1], pyr_l.shape[2]
    dy = torch.arange(-SAD_W, SAD_W + 1, device=dev)
    dxr = torch.arange(-SAD_W - SAD_L, SAD_W + SAD_L + 1, device=dev)
    gy = torch.clamp(sv_l[:, None] + dy[None, :], 0, h0 - 1)          # [N, 11]
    gxl = torch.clamp(su_l[:, None] + dy[None, :], 0, w0 - 1)         # [N, 11]
    gxr = torch.clamp(su_r0[:, None] + dxr[None, :], 0, w0 - 1)       # [N, 21]

    lvl = oct_l[:, None, None]
    patch_l = pyr_l[lvl, gy[:, :, None], gxl[:, None, :]]             # [N,11,11]
    strip_r = pyr_r[lvl, gy[:, :, None], gxr[:, None, :]]             # [N,11,21]

    patch_l = patch_l - patch_l[:, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]
    sad = []
    for inc in range(2 * SAD_L + 1):
        win = strip_r[:, :, inc:inc + 2 * SAD_W + 1]
        win = win - win[:, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]
        sad.append(torch.sum(torch.abs(patch_l - win), dim=(1, 2)))
    sad = torch.stack(sad, dim=1)                                     # [N, 11]

    best_inc = torch.argmin(sad, dim=1)
    best_sad = _take(sad, best_inc)
    interior = (best_inc > 0) & (best_inc < 2 * SAD_L)
    im1 = _take(sad, torch.clamp(best_inc - 1, min=0))
    ip1 = _take(sad, torch.clamp(best_inc + 1, max=2 * SAD_L))
    denom = 2.0 * (im1 + ip1 - 2.0 * best_sad)
    big_denom = torch.abs(denom) > 1e-6
    delta = torch.where(big_denom,
                        (im1 - ip1) / torch.where(big_denom, denom,
                                                  torch.ones_like(denom)),
                        torch.full_like(denom, 2.0))
    delta_ok = (delta >= -1.0) & (delta <= 1.0)

    scale_l = scale_factors[oct_l]
    best_u_r = scale_l * (su_r0.to(torch.float32) +
                          (best_inc - SAD_L).to(torch.float32) + delta)
    disparity = uL - best_u_r
    disp_in_range = (disparity >= 0.0) & (disparity < max_d)
    tiny = disparity <= 0.0
    disparity = torch.where(tiny, torch.full_like(disparity, 0.01), disparity)
    best_u_r = torch.where(tiny, uL - 0.01, best_u_r)

    accept = cand_ok & in_bounds & interior & delta_ok & disp_in_range & valid_l

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
