"""Scale pyramid with parallel mask pyramid and the blurred levels.

Behavioral equivalent of the reference's ComputePyramid
(ORBextractor.cc:1121-1156): ``n_levels`` levels at scale factor ~1.2, and
the AirDOS mask pyramid where the level-0 mask is eroded (10x10 by
default, ``mask_erode``) before downscaling.  Each level is resized from the previous one.  Each level's
7x7 Gaussian blur (ORBextractor.cc:1105, what rBRIEF samples) is built
with it.

``build_pyramid`` calls ``pyramid_level`` once a level: on a CUDA tensor
it launches the sm_90a kernel of ``csrc/pyramid.cu`` on the calling
thread's current stream (built with nvcc at first use into
``airdos_tpu_torch/_build/``, bound through ctypes) or raises, and counts
the launch, by thread and stream priority too; on a CPU tensor it runs
``pyramid_level_ref``, the plain composition of ops/filters.py's erode,
resize_bilinear, the > 0.999 threshold and gaussian_blur7.  The two are
bit-equal.  The kernel design and what bounds it are described at the top
of the CUDA source.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from airdos_tpu_torch.ops import cuda_build
from airdos_tpu_torch.ops.filters import (_gauss_kernel1d, erode,
                                          gaussian_blur7, resize_bilinear)


def level_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> List[Tuple[int, int]]:
    shapes = []
    for lvl in range(n_levels):
        s = 1.0 / (scale_factor ** lvl)
        shapes.append((int(round(h * s)), int(round(w * s))))
    return shapes


class Pyramid(NamedTuple):
    images: Tuple[torch.Tensor, ...]         # per-level [h_l, w_l] float32
    masks: Tuple[torch.Tensor, ...]          # per-level [h_l, w_l] float32 (1 = usable)
    blurred: Tuple[torch.Tensor, ...]        # per-level 7x7 sigma-2 blur of images
    scales: Tuple[float, ...]                # factor ** lvl


def pyramid_level_ref(src: torch.Tensor, src_mask: Optional[torch.Tensor],
                      out_h: int, out_w: int, level0: bool,
                      mask_erode: int = 10):
    """Plain torch version of one level: (image, mask, blur), each [out_h,
    out_w] float32.  Level 0 (level0): src is the image itself, the mask
    the mask_erode x mask_erode erosion of src_mask (all ones for None).
    Else src and src_mask are the previous level's image and mask."""
    if level0:
        img = src
        mask = torch.ones(src.shape, dtype=torch.float32, device=src.device) \
            if src_mask is None else erode(src_mask.to(torch.float32),
                                           mask_erode)
    else:
        img = resize_bilinear(src, out_h, out_w)
        mask = (resize_bilinear(src_mask, out_h, out_w) > 0.999) \
            .to(torch.float32)
    return img, mask, gaussian_blur7(img)


_SOURCE = cuda_build.CSRC / "pyramid.cu"
_SIGNATURES = {
    "airdos_pyramid_level": [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
MAX_ERODE = 16                   # the kernel's largest erosion window
_MASK_KIND = {None: 0, torch.uint8: 1, torch.float32: 2}
_kernel = None                   # the bound C entry point, once loaded
_TAPS = (ctypes.c_float * 7)(*_gauss_kernel1d(7, 2.0))

_counter = cuda_build.LaunchCounter()


def launches() -> int:
    """Kernel launches since the last reset_launches()."""
    return _counter.total


def launch_tally() -> dict:
    """{("pyramid", thread name, stream priority): launches} since the last
    reset_launches()."""
    return {("pyramid",) + key: n for key, n in _counter.tally().items()}


def reset_launches() -> None:
    _counter.reset()


def build():
    """Compile csrc/pyramid.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def _check_2d(name, x, dtypes, device=None):
    if not x.is_cuda or x.dtype not in dtypes or x.dim() != 2 \
            or not x.is_contiguous() or (device is not None
                                         and x.device != device):
        raise ValueError(f"{name} must be a contiguous CUDA [H, W] tensor of "
                         f"{', '.join(str(d) for d in dtypes)}"
                         f"{'' if device is None else f' on {device}'}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")


def pyramid_level_cuda(src: torch.Tensor, src_mask: Optional[torch.Tensor],
                       out_h: int, out_w: int, level0: bool,
                       mask_erode: int = 10):
    """Launch the sm_90a kernel on the current stream: pyramid_level_ref's
    (image, mask, blur)."""
    global _kernel
    _check_2d("src", src, (torch.float32,))
    if not 1 <= mask_erode <= MAX_ERODE:
        raise ValueError(f"mask_erode {mask_erode}: the kernel erodes with "
                         f"a window of 1 to {MAX_ERODE} pixels")
    hs, ws = src.shape
    if level0:
        if (out_h, out_w) != (hs, ws):
            raise ValueError(f"level 0 is {hs}x{ws}, not {out_h}x{out_w}")
        if src_mask is not None:
            _check_2d("src_mask", src_mask, (torch.uint8, torch.float32),
                      src.device)
    else:
        if src_mask is None:
            raise ValueError("a level after the first needs the previous "
                             "level's mask")
        _check_2d("src_mask", src_mask, (torch.float32,), src.device)
    if src_mask is not None and src_mask.shape != src.shape:
        raise ValueError(f"src_mask {tuple(src_mask.shape)} for src "
                         f"{tuple(src.shape)}")
    if min(out_h, out_w) < 4:
        raise ValueError(f"{out_h}x{out_w} level: the blur's reflect border "
                         f"needs 4 pixels a side")
    if max(hs * ws, out_h * out_w) >= 2 ** 31:
        raise ValueError(f"{hs}x{ws} image exceeds the kernel's indexing")
    if _kernel is None:
        _kernel = cuda_build.library(_SOURCE,
                                     _SIGNATURES).airdos_pyramid_level
    dev = src.device
    img = src if level0 else torch.empty((out_h, out_w), dtype=torch.float32,
                                         device=dev)
    mask = torch.empty((out_h, out_w), dtype=torch.float32, device=dev)
    blur = torch.empty((out_h, out_w), dtype=torch.float32, device=dev)
    kind = _MASK_KIND[None if src_mask is None else src_mask.dtype]
    with cuda_build.on_device(dev):
        err = _kernel(src.data_ptr(),
                      None if src_mask is None else src_mask.data_ptr(),
                      kind, hs, ws, None if level0 else img.data_ptr(),
                      mask.data_ptr(), blur.data_ptr(), out_h, out_w,
                      float(np.float32(hs / out_h)),
                      float(np.float32(ws / out_w)), _TAPS, int(level0),
                      mask_erode, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pyramid kernel launch failed: cudaError {err}")
    _counter.count(cuda_build.stream_priority(dev))
    return img, mask, blur


def pyramid_level(src: torch.Tensor, src_mask: Optional[torch.Tensor],
                  out_h: int, out_w: int, level0: bool,
                  mask_erode: int = 10):
    """One level's (image, mask, blur): CUDA tensors go to the kernel, CPU
    tensors to the plain version."""
    if src.is_cuda:
        return pyramid_level_cuda(src, src_mask, out_h, out_w, level0,
                                  mask_erode)
    return pyramid_level_ref(src, src_mask, out_h, out_w, level0, mask_erode)


def build_pyramid(img: torch.Tensor,
                  mask: Optional[torch.Tensor],
                  n_levels: int = 8,
                  scale_factor: float = 1.2,
                  mask_erode: int = 10) -> Pyramid:
    """img: [H, W] float32.  mask: [H, W] with 1 = usable pixel, or None
    for no masking; it is eroded mask_erode x mask_erode (1 to MAX_ERODE
    on the card) before level 0."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale_factor)
    levels = [pyramid_level(img, mask, h, w, True, mask_erode)]
    for hl, wl in shapes[1:]:
        prev_img, prev_mask, _ = levels[-1]
        levels.append(pyramid_level(prev_img, prev_mask, hl, wl, False))
    images, masks, blurred = (tuple(x) for x in zip(*levels))
    scales = tuple(scale_factor ** lvl for lvl in range(n_levels))
    return Pyramid(images, masks, blurred, scales)
