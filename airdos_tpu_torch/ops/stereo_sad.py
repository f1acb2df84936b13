"""Stereo sub-pixel refinement of the left keypoints: CUDA kernel + plain
twin.

Step 3 of matching/stereo.stereo_match (reference Frame.cc:904-976): for
each left keypoint and its best right candidate, an 11x11 centre-subtracted
L1 SAD window on the left keypoint's pyramid level, slid +-5 px along the
right image's row; the first minimum, the parabola through it and its
neighbours, and the tests that accept the match before the median cut.

``stereo_sad`` takes the two images' pyramid levels as they are:

- on CUDA tensors it launches the sm_90a kernel of ``csrc/stereo_sad.cu``
  (half a warp a keypoint, the levels read where they lie) on the calling
  thread's current stream (built with nvcc at first use into
  ``airdos_tpu_torch/_build/``, bound through ctypes) or raises, and
  counts the launch, by thread and stream priority too;
- on CPU tensors it runs ``stereo_sad_ref``: the levels zero-padded into
  [L, H0, W0] stacks (``stack_pyramid``, airdos_tpu's layout), then
  gathers of the windows and the sums.

Both return (best_sad, u_right, disparity [N] float32, accept [N] bool).
The two are bit-equal where every pixel of the windows is 0 or at least
2^-8 in magnitude, as in an 8-bit level 0 and, away from zero pixels, its
bilinear levels: both sum each SAD's 121 float32 terms exactly in float64
and round once (csrc/stereo_sad.cu says why the sums are exact then).
Elsewhere a float64 sum can round, each version in its own order, and a
SAD may differ by a float32 ulp.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from airdos_tpu_torch.ops import cuda_build

SAD_W = 5                          # half window (11x11)
SAD_L = 5                          # slide range
# csrc/stereo_sad.cu: LANES lanes (half a warp) a keypoint, KEYPOINTS of
# them a block
LANES = 16
KEYPOINTS = 4


def lane_columns(lane: int):
    """The window columns lane `lane` of a keypoint's LANES loads: its
    patch column (None past the patch) and its strip columns."""
    win, strip = 2 * SAD_W + 1, 2 * (SAD_W + SAD_L) + 1
    return (lane if lane < win else None,
            [c for c in (lane, lane + LANES) if c < strip])


def outputs(n: int, device):
    """(best_sad, u_right, disparity [n] float32, accept [n] bool): views
    of one allocation, three float32 rows, then the flags' bytes."""
    buf = torch.empty(3 * n + (n + 3) // 4, dtype=torch.float32,
                      device=device)
    best_sad, u_r, disparity = buf[:3 * n].view(3, n).unbind(0)
    return best_sad, u_r, disparity, \
        buf[3 * n:].view(torch.uint8)[:n].view(torch.bool)


def stack_pyramid(images: Sequence[torch.Tensor]) -> torch.Tensor:
    """Pad per-level images into one [L, H0, W0] stack (zeros outside) so a
    per-keypoint level index can gather windows from any level."""
    h0, w0 = images[0].shape
    return torch.stack([F.pad(im, (0, w0 - im.shape[1], 0, h0 - im.shape[0]))
                        for im in images], dim=0)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[i, idx[i]] for a 2-D x."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


def stereo_sad_ref(xy_l, oct_l, valid_l, xy_r, best_r, cand_ok,
                   levels_l: Sequence[torch.Tensor],
                   levels_r: Sequence[torch.Tensor], level_widths,
                   scale_factors, max_d: float):
    """Plain torch version.  xy_l [N, 2], xy_r [M, 2] float32 level-0
    coordinates; oct_l, best_r [N] int64; valid_l, cand_ok [N] bool;
    levels_* the pyramid levels [h_l, w_l] float32; level_widths [L]
    int64; scale_factors [L] float32; max_d the float32 bf / baseline."""
    dev = xy_l.device
    pyr_l, pyr_r = stack_pyramid(levels_l), stack_pyramid(levels_r)
    uL, vL = xy_l[:, 0], xy_l[:, 1]
    inv_scale = 1.0 / scale_factors[oct_l]
    su_l = torch.round(uL * inv_scale).to(torch.int64)
    sv_l = torch.round(vL * inv_scale).to(torch.int64)
    uR0 = xy_r[best_r, 0]
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
        # exact in float64 (see the module docstring), rounded once
        sad.append(torch.sum(torch.abs(patch_l - win), dim=(1, 2),
                             dtype=torch.float64).to(torch.float32))
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
    return best_sad, best_u_r, disparity, accept


_SOURCE = cuda_build.CSRC / "stereo_sad.cu"
_SIGNATURES = {
    "airdos_stereo_sad": [ctypes.POINTER(ctypes.c_int64)] * 2
    + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 8 + [ctypes.c_float] + [ctypes.c_void_p] * 5,
}
_kernel = None                   # the bound C entry point, once loaded
MAX_LEVELS = 16                  # the kernel's Levels table

_counter = cuda_build.LaunchCounter()


def launches() -> int:
    """Kernel launches since the last reset_launches()."""
    return _counter.total


def launch_tally() -> dict:
    """{("stereo_sad", thread name, stream priority): launches} since the
    last reset_launches()."""
    return {("stereo_sad",) + key: n for key, n in _counter.tally().items()}


def reset_launches() -> None:
    _counter.reset()


def build():
    """Compile csrc/stereo_sad.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def _check(name, x, dtype, dim, device):
    if not x.is_cuda or x.device != device or x.dtype != dtype \
            or x.dim() != dim or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous CUDA {dtype} tensor "
                         f"of {dim} dimensions on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def stereo_sad_cuda(xy_l, oct_l, valid_l, xy_r, best_r, cand_ok,
                    levels_l: Sequence[torch.Tensor],
                    levels_r: Sequence[torch.Tensor], level_widths,
                    scale_factors, max_d: float):
    """Launch the sm_90a kernel on the current stream."""
    global _kernel
    dev = xy_l.device
    levels_l, levels_r = tuple(levels_l), tuple(levels_r)
    n_levels = len(levels_l)
    if not 0 < n_levels <= MAX_LEVELS or len(levels_r) != n_levels:
        raise ValueError(f"{n_levels} left and {len(levels_r)} right levels "
                         f"(1 to {MAX_LEVELS} each)")
    for side, levels in (("left", levels_l), ("right", levels_r)):
        for lvl, im in enumerate(levels):
            _check(f"{side} level {lvl}", im, torch.float32, 2, dev)
            if im.shape != levels_l[lvl].shape:
                raise ValueError(f"right level {lvl} {tuple(im.shape)} for "
                                 f"left {tuple(levels_l[lvl].shape)}")
    h0, w0 = levels_l[0].shape
    if h0 * w0 >= 2 ** 31:
        raise ValueError(f"{h0}x{w0} level 0 exceeds the kernel's indexing")
    for name, x, dtype, dim in (("xy_l", xy_l, torch.float32, 2),
                                ("oct_l", oct_l, torch.int64, 1),
                                ("valid_l", valid_l, torch.bool, 1),
                                ("xy_r", xy_r, torch.float32, 2),
                                ("best_r", best_r, torch.int64, 1),
                                ("cand_ok", cand_ok, torch.bool, 1),
                                ("level_widths", level_widths, torch.int64, 1),
                                ("scale_factors", scale_factors,
                                 torch.float32, 1)):
        _check(name, x, dtype, dim, dev)
    n = xy_l.shape[0]
    if xy_l.shape[1] != 2 or xy_r.shape[1] != 2 or any(
            x.shape[0] != n for x in (oct_l, valid_l, best_r, cand_ok)) or \
            level_widths.shape[0] != n_levels or \
            scale_factors.shape[0] != n_levels:
        raise ValueError(f"xy_l {tuple(xy_l.shape)}, xy_r "
                         f"{tuple(xy_r.shape)}, oct_l {tuple(oct_l.shape)}, "
                         f"valid_l {tuple(valid_l.shape)}, best_r "
                         f"{tuple(best_r.shape)}, cand_ok "
                         f"{tuple(cand_ok.shape)}, {n_levels} levels, widths "
                         f"{tuple(level_widths.shape)}, scales "
                         f"{tuple(scale_factors.shape)}")
    if _kernel is None:
        _kernel = cuda_build.library(_SOURCE, _SIGNATURES).airdos_stereo_sad
    best_sad, u_r, disparity, accept = outputs(n, dev)

    def ptrs(levels):
        return (ctypes.c_int64 * n_levels)(*(im.data_ptr() for im in levels))

    def ints(vals):
        return (ctypes.c_int * n_levels)(*vals)

    with cuda_build.on_device(dev):
        err = _kernel(ptrs(levels_l), ptrs(levels_r),
                      ints(im.shape[0] for im in levels_l),
                      ints(im.shape[1] for im in levels_l), n_levels, h0, w0,
                      n, xy_l.data_ptr(), oct_l.data_ptr(),
                      valid_l.data_ptr(), xy_r.data_ptr(), best_r.data_ptr(),
                      cand_ok.data_ptr(), level_widths.data_ptr(),
                      scale_factors.data_ptr(), float(max_d),
                      best_sad.data_ptr(), u_r.data_ptr(),
                      disparity.data_ptr(), accept.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stereo_sad kernel launch failed: cudaError {err}")
    _counter.count(cuda_build.stream_priority(dev))
    return best_sad, u_r, disparity, accept


def stereo_sad(xy_l, oct_l, valid_l, xy_r, best_r, cand_ok, levels_l,
               levels_r, level_widths, scale_factors, max_d: float):
    """(best_sad, u_right, disparity, accept) of the left keypoints before
    the median cut: CUDA tensors go to the kernel, CPU tensors to the
    plain version."""
    if xy_l.is_cuda:
        return stereo_sad_cuda(xy_l, oct_l, valid_l, xy_r, best_r, cand_ok,
                               levels_l, levels_r, level_widths,
                               scale_factors, max_d)
    return stereo_sad_ref(xy_l, oct_l, valid_l, xy_r, best_r, cand_ok,
                          levels_l, levels_r, level_widths, scale_factors,
                          max_d)
