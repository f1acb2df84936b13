"""Stereo disparity by SAD block matching, for human-pose association.

The reference runs cv::StereoSGBM (48 disparities, SAD window 11) once a
frame only to guide the left<->right human-pose association
(src/Frame.cc:313-416).  As in airdos_tpu/ops/disparity.py:

- ``patch_disparity`` matches only at the requested left pixels (the
  torso joints of the detections): a [N, D, B, B] gather, the path's form;
- ``disparity_bm`` is the dense [H, W] map (block-matching cost volume,
  11x11 box filter, uniqueness check), for tools and tests.

Both take the first minimum of the SAD where several tie (``argmin``
returns the first index on the CPU and on CUDA, as ``jnp.argmin`` does),
and round pixel coordinates half to even (``torch.round``, like
``jnp.round``).  SADs of 8-bit images are integer sums, exact in float32,
so the argmin is the same in both packages.  Plain torch: a gather, not a
Pallas kernel in airdos_tpu (ROADMAP Hopper queue: patch_disparity).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _box_filter(x: torch.Tensor, k: int) -> torch.Tensor:
    """[D, H, W] sums over k x k windows, zero padding, SAME size."""
    lo = k // 2
    hi = k - 1 - lo
    h, w = x.shape[-2:]
    p = F.pad(x, (lo, hi, lo, hi))
    rows = sum(p[..., i:i + h, :] for i in range(k))
    return sum(rows[..., j:j + w] for j in range(k))


def _subpixel(cost: torch.Tensor, best: torch.Tensor, num_disp: int,
              dim: int):
    """Parabola refinement of the integer argmin along `dim`; returns the
    disparity and the cost at the minimum."""
    def take(idx):
        return torch.gather(cost, dim, idx.unsqueeze(dim)).squeeze(dim)
    c_m = take(torch.clamp(best - 1, 0, num_disp - 1))
    c_0 = take(best)
    c_p = take(torch.clamp(best + 1, 0, num_disp - 1))
    denom = c_m + c_p - 2.0 * c_0
    ok = torch.abs(denom) > 1e-6
    delta = torch.where(ok, 0.5 * (c_m - c_p)
                        / torch.where(ok, denom, torch.ones_like(denom)),
                        torch.zeros_like(denom))
    return best.to(torch.float32) + torch.clamp(delta, -0.5, 0.5), c_0


def patch_disparity(im_left: torch.Tensor, im_right: torch.Tensor,
                    px: torch.Tensor, num_disp: int = 48,
                    block: int = 11) -> torch.Tensor:
    """Disparity at given left-image pixels only.

    im_left, im_right: [H, W] float32; px: [N, 2] float32 (u, v).
    Returns [N] float32 disparity; -1 where invalid (pixel outside the
    image, minimum at either end of the range, or no fully covered
    window)."""
    h, w = im_left.shape
    dev = im_left.device
    half = block // 2
    u = torch.round(px[:, 0]).to(torch.int64)
    v = torch.round(px[:, 1]).to(torch.int64)
    inb_px = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    off = torch.arange(-half, half + 1, device=dev)
    yy = torch.clamp(v[:, None] + off[None, :], 0, h - 1)          # [N, B]
    xxL = torch.clamp(u[:, None] + off[None, :], 0, w - 1)         # [N, B]
    patchL = im_left[yy[:, :, None], xxL[:, None, :]]              # [N, B, B]
    d = torch.arange(num_disp, device=dev)
    xxR = u[:, None, None] - d[None, :, None] + off[None, None, :]  # [N, D, B]
    covered = (xxR >= 0).all(dim=-1)                                # [N, D]
    xxRc = torch.clamp(xxR, 0, w - 1)
    patchR = im_right[yy[:, None, :, None], xxRc[:, :, None, :]]    # [N, D, B, B]
    sad = torch.abs(patchL[:, None] - patchR).sum(dim=(-2, -1))     # [N, D]
    sad = sad + torch.where(covered, 0.0, 1e8)
    best = torch.argmin(sad, dim=1)
    disp, c_0 = _subpixel(sad, best, num_disp, 1)
    valid = inb_px & (best > 0) & (best < num_disp - 1) & (c_0 < 1e7)
    return torch.where(valid, disp, torch.full_like(disp, -1.0))


def disparity_bm(im_left: torch.Tensor, im_right: torch.Tensor,
                 num_disp: int = 48, block: int = 11,
                 uniqueness: float = 0.15) -> torch.Tensor:
    """Left-image disparity map [H, W] float32; invalid pixels -> -1.
    Disparity d means im_left[y, x] ~ im_right[y, x - d]."""
    h, w = im_left.shape
    band = 1e6 / max(block * block, 1)      # cost of the uncovered band
    costs = []
    for d in range(num_disp):
        shifted = F.pad(im_right, (d, 0))[:, :w]
        ad = torch.abs(im_left - shifted)
        ad[:, :d] = band
        costs.append(ad)
    vol = _box_filter(torch.stack(costs, dim=0), block)          # [D, H, W]

    best = torch.argmin(vol, dim=0)                              # [H, W]
    cmin = torch.gather(vol, 0, best[None])[0]
    # uniqueness: the best cost away from best +- 1 must be worse enough
    d_idx = torch.arange(num_disp, device=vol.device)[:, None, None]
    near = torch.abs(d_idx - best[None]) <= 1
    c2 = torch.where(near, torch.full_like(vol, float("inf")), vol).amin(0)
    unique_ok = cmin * (1.0 + uniqueness) <= c2

    disp, _ = _subpixel(vol, best, num_disp, 0)
    valid = unique_ok & (best > 0) & (best < num_disp - 1)
    return torch.where(valid, disp, torch.full_like(disp, -1.0))
