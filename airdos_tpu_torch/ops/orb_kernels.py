"""IC angle and rBRIEF descriptor of one level's keypoints: CUDA kernel +
plain twin.

The extractor (features/orb.py) calls ``orb_describe`` once per pyramid
level with the level, its blurred copy and the level's keypoints:

- on a CUDA tensor it launches the sm_90a kernel of ``csrc/orb_desc.cu``
  on the calling thread's current stream (built with nvcc at first use
  into ``airdos_tpu_torch/_build/``, bound through ctypes) or raises, and
  counts the launch, by thread and stream priority too;
- on a CPU tensor it runs ``orb_describe_ref``: ops/orientation.py
  ``keypoint_angles``, then ops/brief.py ``compute_descriptors`` at those
  angles and ``pack_u32``.

Both return the angles [N] float32 in degrees and the descriptors as
[N, 8] int32 bit views of the little-endian uint32 words, the bytes
``pack_u32`` gives.  The kernel design and what bounds it are described
at the top of the CUDA source.

The two agree bit for bit where every nonzero pixel of a keypoint's
radius-15 disc is at least 2^-8, as in any 8-bit image: both sum the
intensity moments exactly in float64 and round once to float32.  A
bilinear pyramid level can hold smaller values beside zero pixels, and
such a pixel can make the float64 sums round, in an order-dependent way.
The float32 moments, and so the angle and the descriptor, then still
agree unless a float64 sum lies within ~700 float64 ulps (of its largest
partial sum) of a float32 rounding boundary.  Where that happens the
keypoint's angle moves by a float32 ulp and may flip descriptor bits, so
chip_smoke.py holds the kernel to >= 99.9% of equal descriptors rather
than to bit equality.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from airdos_tpu_torch.ops import cuda_build
from airdos_tpu_torch.ops.brief import (compute_descriptors, load_pattern,
                                        pack_u32)
from airdos_tpu_torch.ops.orientation import keypoint_angles

_SOURCE = cuda_build.CSRC / "orb_desc.cu"
_SIGNATURES = {
    "airdos_orb_desc": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 3,
}
_kernel = None                   # the bound C entry point, once loaded
_patterns = {}                   # device -> [2, 512] float32 pattern points
_patterns_lock = threading.Lock()

_counter = cuda_build.LaunchCounter()


def launches() -> int:
    """Kernel launches since the last reset_launches()."""
    return _counter.total


def launch_tally() -> dict:
    """{("orb_desc", thread name, stream priority): launches} since the
    last reset_launches()."""
    return {("orb_desc",) + key: n for key, n in _counter.tally().items()}


def reset_launches() -> None:
    _counter.reset()


def build():
    """Compile csrc/orb_desc.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def pattern_points(device) -> torch.Tensor:
    """[2, 512] float32: the x and the y of the 512 rBRIEF pattern points
    (the first points of the 256 pairs, then the second), as
    compute_descriptors rotates them."""
    pat = torch.as_tensor(load_pattern())
    return torch.stack([torch.cat([pat[:, 0], pat[:, 2]]),
                        torch.cat([pat[:, 1], pat[:, 3]])]) \
        .to(torch.float32).to(device).contiguous()


def _pattern_on(device) -> torch.Tensor:
    with _patterns_lock:
        pat = _patterns.get(device)
        if pat is None:
            pat = _patterns[device] = pattern_points(device)
    return pat


def orb_describe_ref(img: torch.Tensor, img_blur: torch.Tensor,
                     xs: torch.Tensor, ys: torch.Tensor):
    """Plain torch version: (angles [N] float32 degrees, descriptor words
    [N, 8] int32)."""
    ang = keypoint_angles(img, xs, ys)
    return ang, pack_u32(compute_descriptors(img_blur, xs, ys, ang))


def orb_describe_cuda(img: torch.Tensor, img_blur: torch.Tensor,
                      xs: torch.Tensor, ys: torch.Tensor):
    """Launch the sm_90a kernel on the current stream."""
    global _kernel
    for name, x in (("img", img), ("img_blur", img_blur)):
        if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2 \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA float32 "
                             f"[H, W] tensor, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if img_blur.device != img.device or img_blur.shape != img.shape:
        raise ValueError(f"img_blur {tuple(img_blur.shape)} on "
                         f"{img_blur.device} for img {tuple(img.shape)} on "
                         f"{img.device}")
    for name, x in (("xs", xs), ("ys", ys)):
        if x.device != img.device or x.dtype != torch.int64 or x.dim() != 1 \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int64 vector on "
                             f"{img.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if xs.shape != ys.shape:
        raise ValueError(f"xs {tuple(xs.shape)} and ys {tuple(ys.shape)}")
    h, w = img.shape
    n = xs.shape[0]
    if _kernel is None:
        _kernel = cuda_build.library(_SOURCE, _SIGNATURES).airdos_orb_desc
    angle = torch.empty(n, dtype=torch.float32, device=img.device)
    desc = torch.empty((n, 8), dtype=torch.int32, device=img.device)
    with cuda_build.on_device(img.device):
        err = _kernel(img.data_ptr(), img_blur.data_ptr(), xs.data_ptr(),
                      ys.data_ptr(), _pattern_on(img.device).data_ptr(), n,
                      h, w, angle.data_ptr(), desc.data_ptr(),
                      torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"orb_desc kernel launch failed: cudaError {err}")
    _counter.count(cuda_build.stream_priority(img.device))
    return angle, desc


def orb_describe(img: torch.Tensor, img_blur: torch.Tensor,
                 xs: torch.Tensor, ys: torch.Tensor):
    """(angles, descriptor words) of the keypoints (xs, ys) [N] int64 of
    one level img [H, W] float32, whose 7x7 blur is img_blur: CUDA tensors
    go to the kernel, CPU tensors to the plain version."""
    if img.is_cuda:
        return orb_describe_cuda(img, img_blur, xs, ys)
    return orb_describe_ref(img, img_blur, xs, ys)
