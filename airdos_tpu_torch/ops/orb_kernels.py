"""IC angle and rBRIEF descriptor of an image's keypoints: CUDA kernel +
plain twin.

The extractor (features/orb.py) calls ``orb_describe_levels`` once an
image, with the pyramid's levels, their blurred copies and the
selection's keypoints of every level, concatenated level after level
(``quotas`` slots a level); ``orb_describe`` is the one-level case:

- on CUDA tensors they launch the sm_90a kernel of ``csrc/orb_desc.cu``
  (one launch for all the levels, at most ``MAX_LEVELS``) on the calling
  thread's current stream (built with nvcc at first use into
  ``airdos_tpu_torch/_build/``, bound through ctypes) or raise, and count
  the launch, by thread and stream priority too;
- on CPU tensors they run ``orb_describe_levels_ref`` /
  ``orb_describe_ref``: ops/orientation.py ``keypoint_angles``, then
  ops/brief.py ``compute_descriptors`` at those angles and ``pack_u32``,
  level by level.

Both return the angles [N] float32 in degrees and the descriptors as
[N, 8] int32 bit views of the little-endian uint32 words, the bytes
``pack_u32`` gives.  The kernel design and what bounds it are described
at the top of the CUDA source; ``level_table`` and ``slot_level`` are the
kernel's level table and the level it finds for a slot.

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
from typing import List, Sequence

import torch

from airdos_tpu_torch.ops import cuda_build
from airdos_tpu_torch.ops.brief import (compute_descriptors, load_pattern,
                                        pack_u32)
from airdos_tpu_torch.ops.orientation import keypoint_angles

_SOURCE = cuda_build.CSRC / "orb_desc.cu"
_I32P = ctypes.POINTER(ctypes.c_int)
_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "airdos_orb_desc": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 3,
    "airdos_orb_desc_levels": [_I64P] * 2 + [_I32P] * 3 + [ctypes.c_int]
    + [ctypes.c_void_p] * 6,
}
MAX_LEVELS = 16                  # the kernel's level table
_lib = None                      # the loaded library, once built
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


def level_table(quotas: Sequence[int]) -> List[int]:
    """The first slot of each level in the concatenated slots: the level
    table's first slots, as the C entry point fills them."""
    first, out = 0, []
    for q in quotas:
        out.append(first)
        first += int(q)
    return out


def slot_level(slot: int, first: Sequence[int]) -> int:
    """The level the kernel's warp for `slot` describes: the last level
    whose first slot is at most `slot` (csrc/orb_desc.cu's walk of the
    level table; a level with no slot shares its first slot with the next
    and is passed over)."""
    lvl = 0
    while lvl + 1 < len(first) and slot >= first[lvl + 1]:
        lvl += 1
    return lvl


def orb_describe_ref(img: torch.Tensor, img_blur: torch.Tensor,
                     xs: torch.Tensor, ys: torch.Tensor):
    """Plain torch version: (angles [N] float32 degrees, descriptor words
    [N, 8] int32)."""
    ang = keypoint_angles(img, xs, ys)
    return ang, pack_u32(compute_descriptors(img_blur, xs, ys, ang))


def orb_describe_levels_ref(images: Sequence[torch.Tensor],
                            blurred: Sequence[torch.Tensor],
                            xs: torch.Tensor, ys: torch.Tensor,
                            quotas: Sequence[int]):
    """Plain torch version: orb_describe_ref of each level's slots,
    concatenated."""
    parts = [orb_describe_ref(img, blur, xs[f:f + q], ys[f:f + q])
             for img, blur, f, q in zip(images, blurred,
                                        level_table(quotas), quotas)]
    return tuple(torch.cat(x) for x in zip(*parts))


def _check_level(lvl, img, img_blur, device) -> None:
    for name, x in (("img", img), ("img_blur", img_blur)):
        if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 2 \
                or not x.is_contiguous() or x.device != device:
            raise ValueError(f"{name} of level {lvl} must be a contiguous "
                             f"CUDA float32 [H, W] tensor on {device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if img_blur.shape != img.shape:
        raise ValueError(f"img_blur {tuple(img_blur.shape)} for img "
                         f"{tuple(img.shape)} at level {lvl}")


def _check_slots(xs, ys, n, device) -> None:
    for name, x in (("xs", xs), ("ys", ys)):
        if x.device != device or x.dtype != torch.int64 or x.dim() != 1 \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int64 vector on "
                             f"{device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if xs.shape != ys.shape or (n is not None and xs.shape[0] != n):
        raise ValueError(f"xs {tuple(xs.shape)} and ys {tuple(ys.shape)} "
                         f"for {n} slots")


def _library():
    global _lib
    if _lib is None:
        _lib = cuda_build.library(_SOURCE, _SIGNATURES)
    return _lib


def orb_describe_cuda(img: torch.Tensor, img_blur: torch.Tensor,
                      xs: torch.Tensor, ys: torch.Tensor):
    """Launch the sm_90a kernel on the current stream for one level."""
    if not img.is_cuda:
        raise ValueError(f"img must be a CUDA tensor, got {img.device}")
    _check_level(0, img, img_blur, img.device)
    _check_slots(xs, ys, None, img.device)
    h, w = img.shape
    n = xs.shape[0]
    kernel = _library().airdos_orb_desc
    angle = torch.empty(n, dtype=torch.float32, device=img.device)
    desc = torch.empty((n, 8), dtype=torch.int32, device=img.device)
    with cuda_build.on_device(img.device):
        err = kernel(img.data_ptr(), img_blur.data_ptr(), xs.data_ptr(),
                     ys.data_ptr(), _pattern_on(img.device).data_ptr(), n,
                     h, w, angle.data_ptr(), desc.data_ptr(),
                     torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"orb_desc kernel launch failed: cudaError {err}")
    _counter.count(cuda_build.stream_priority(img.device))
    return angle, desc


def orb_describe_levels_cuda(images: Sequence[torch.Tensor],
                             blurred: Sequence[torch.Tensor],
                             xs: torch.Tensor, ys: torch.Tensor,
                             quotas: Sequence[int]):
    """Launch the sm_90a kernel on the current stream for all the levels
    at once (no launch when there is no slot)."""
    images, blurred, quotas = tuple(images), tuple(blurred), tuple(quotas)
    n = len(images)
    if not 0 < n <= MAX_LEVELS or len(blurred) != n or len(quotas) != n:
        raise ValueError(f"{n} levels (1 to {MAX_LEVELS}), {len(blurred)} "
                         f"blurred, {len(quotas)} quotas")
    if min(quotas) < 0:
        raise ValueError(f"quotas {quotas}")
    dev = images[0].device
    if not images[0].is_cuda:
        raise ValueError(f"the levels must be CUDA tensors, got {dev}")
    for lvl, (img, blur) in enumerate(zip(images, blurred)):
        _check_level(lvl, img, blur, dev)
    total = int(sum(quotas))
    _check_slots(xs, ys, total, dev)
    kernel = _library().airdos_orb_desc_levels

    def ints(vals):
        return (ctypes.c_int * n)(*(int(v) for v in vals))

    angle = torch.empty(total, dtype=torch.float32, device=dev)
    desc = torch.empty((total, 8), dtype=torch.int32, device=dev)
    if total == 0:
        return angle, desc
    with cuda_build.on_device(dev):
        err = kernel((ctypes.c_int64 * n)(*(x.data_ptr() for x in images)),
                     (ctypes.c_int64 * n)(*(x.data_ptr() for x in blurred)),
                     ints(x.shape[0] for x in images),
                     ints(x.shape[1] for x in images), ints(quotas), n,
                     xs.data_ptr(), ys.data_ptr(),
                     _pattern_on(dev).data_ptr(), angle.data_ptr(),
                     desc.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"orb_desc kernel launch failed: cudaError {err}")
    _counter.count(cuda_build.stream_priority(dev))
    return angle, desc


def orb_describe(img: torch.Tensor, img_blur: torch.Tensor,
                 xs: torch.Tensor, ys: torch.Tensor):
    """(angles, descriptor words) of the keypoints (xs, ys) [N] int64 of
    one level img [H, W] float32, whose 7x7 blur is img_blur: CUDA tensors
    go to the kernel, CPU tensors to the plain version."""
    if img.is_cuda:
        return orb_describe_cuda(img, img_blur, xs, ys)
    return orb_describe_ref(img, img_blur, xs, ys)


def orb_describe_levels(images: Sequence[torch.Tensor],
                        blurred: Sequence[torch.Tensor], xs: torch.Tensor,
                        ys: torch.Tensor, quotas: Sequence[int]):
    """(angles, descriptor words) of every slot of an image's levels
    images[l] [H_l, W_l] float32, whose 7x7 blurs are blurred[l]: xs, ys
    [sum(quotas)] int64, quotas[l] slots of level l after those of the
    levels before it.  CUDA tensors go to the kernel (one launch), CPU
    tensors to the plain version."""
    if images[0].is_cuda:
        return orb_describe_levels_cuda(images, blurred, xs, ys, quotas)
    return orb_describe_levels_ref(images, blurred, xs, ys, quotas)
