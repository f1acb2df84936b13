"""Stereo disparity by SAD block matching, for human-pose association.

The reference runs cv::StereoSGBM (48 disparities, SAD window 11) once a
frame only to guide the left<->right human-pose association
(src/Frame.cc:313-416).  As in airdos_tpu/ops/disparity.py:

- ``patch_disparity`` matches only at the requested left pixels (the
  torso joints of the detections), the path's form: on CUDA tensors it
  launches the sm_90a kernel of ``csrc/disparity.cu`` (four warps a
  probe) on the calling thread's current stream (built with nvcc at
  first use into ``airdos_tpu_torch/_build/``, bound through ctypes) or
  raises, and counts the launch, by thread and stream priority too; on
  CPU tensors it runs ``patch_disparity_ref``, a [N, D, B, B] gather;
- ``disparity_bm`` is the dense [H, W] map (block-matching cost volume,
  11x11 box filter, uniqueness check), for tools and tests: plain torch.

Both take the first minimum of the SAD where several tie (``argmin``
returns the first index on the CPU and on CUDA, as ``jnp.argmin`` does),
and round pixel coordinates half to even (``torch.round``, like
``jnp.round``).  SADs of 8-bit images are integer sums, exact in float32,
so the argmin is the same in both packages.  patch_disparity's plain
version sums each SAD in float64 and rounds once, and its kernel sums
exactly (in float32 where every pixel is an integer of magnitude <=
2^15, else in float64), so the two are bit-equal wherever those sums
are exact: on 8-bit images, and on any image whose pixels are 0 or at
least 2^-8 in magnitude (the kernel's source says why).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from airdos_tpu_torch.ops import cuda_build


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


def patch_disparity_ref(im_left: torch.Tensor, im_right: torch.Tensor,
                        px: torch.Tensor, num_disp: int = 48,
                        block: int = 11) -> torch.Tensor:
    """Disparity at given left-image pixels only: the plain torch version.

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
    sad = torch.abs(patchL[:, None] - patchR).sum(
        dim=(-2, -1), dtype=torch.float64).to(torch.float32)       # [N, D]
    sad = sad + torch.where(covered, 0.0, 1e8)
    best = torch.argmin(sad, dim=1)
    disp, c_0 = _subpixel(sad, best, num_disp, 1)
    valid = inb_px & (best > 0) & (best < num_disp - 1) & (c_0 < 1e7)
    return torch.where(valid, disp, torch.full_like(disp, -1.0))


_SOURCE = cuda_build.CSRC / "disparity.cu"
_SIGNATURES = {
    "airdos_patch_disparity": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
}
_kernel = None                   # the bound C entry point, once loaded
MAX_DISP = 64                    # the kernel's shared-memory limits
MAX_BLOCK = 15

_counter = cuda_build.LaunchCounter()


def launches() -> int:
    """Kernel launches since the last reset_launches()."""
    return _counter.total


def launch_tally() -> dict:
    """{("patch_disparity", thread name, stream priority): launches} since
    the last reset_launches()."""
    return {("patch_disparity",) + key: n
            for key, n in _counter.tally().items()}


def reset_launches() -> None:
    _counter.reset()


def build():
    """Compile csrc/disparity.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def patch_disparity_cuda(im_left: torch.Tensor, im_right: torch.Tensor,
                         px: torch.Tensor, num_disp: int = 48,
                         block: int = 11) -> torch.Tensor:
    """Launch the sm_90a kernel on the current stream."""
    global _kernel
    for name, x in (("im_left", im_left), ("im_right", im_right)):
        if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2 \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA float32 "
                             f"[H, W] tensor, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if im_right.device != im_left.device or im_right.shape != im_left.shape:
        raise ValueError(f"im_right {tuple(im_right.shape)} on "
                         f"{im_right.device} for im_left "
                         f"{tuple(im_left.shape)} on {im_left.device}")
    if px.device != im_left.device or px.dtype != torch.float32 \
            or px.dim() != 2 or px.shape[1] != 2 or not px.is_contiguous():
        raise ValueError(f"px must be a contiguous float32 [N, 2] tensor on "
                         f"{im_left.device}, got {px.dtype} "
                         f"{tuple(px.shape)} on {px.device}")
    if not (1 <= num_disp <= MAX_DISP and 1 <= block <= MAX_BLOCK
            and block % 2 == 1):
        raise ValueError(f"num_disp {num_disp} (1 to {MAX_DISP}), block "
                         f"{block} (odd, 1 to {MAX_BLOCK})")
    h, w = im_left.shape
    if h * w >= 2 ** 31:
        raise ValueError(f"{h}x{w} image exceeds the kernel's indexing")
    if _kernel is None:
        _kernel = cuda_build.library(_SOURCE,
                                     _SIGNATURES).airdos_patch_disparity
    n = px.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=im_left.device)
    with cuda_build.on_device(im_left.device):
        err = _kernel(im_left.data_ptr(), im_right.data_ptr(), h, w,
                      px.data_ptr(), n, num_disp, block, out.data_ptr(),
                      torch.cuda.current_stream(im_left.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"patch_disparity kernel launch failed: "
                           f"cudaError {err}")
    _counter.count(cuda_build.stream_priority(im_left.device))
    return out


def patch_disparity(im_left: torch.Tensor, im_right: torch.Tensor,
                    px: torch.Tensor, num_disp: int = 48,
                    block: int = 11) -> torch.Tensor:
    """Disparity [N] float32 at the left-image pixels px [N, 2] float32
    (u, v); -1 where invalid (pixel outside the image, minimum at either
    end of the range, or no fully covered window): CUDA tensors go to the
    kernel, CPU tensors to the plain version."""
    if im_left.is_cuda:
        return patch_disparity_cuda(im_left, im_right, px, num_disp, block)
    return patch_disparity_ref(im_left, im_right, px, num_disp, block)


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
