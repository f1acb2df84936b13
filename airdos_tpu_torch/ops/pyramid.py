"""Scale pyramid with parallel mask pyramid and the blurred levels.

Behavioral equivalent of the reference's ComputePyramid
(ORBextractor.cc:1121-1156): ``n_levels`` levels at scale factor ~1.2, and
the AirDOS mask pyramid where the level-0 mask is eroded (10x10 by
default, ``mask_erode``) before downscaling.  Each level is resized from
the previous one.  Each level's 7x7 Gaussian blur (ORBextractor.cc:1105,
what rBRIEF samples) is built with it.

``build_pyramid`` returns the levels as views into one flat buffer (the
images from level 1 on, the masks, the blurs; level 0's image is the input
itself).  On a CUDA tensor it makes one cooperative launch of the sm_90a
kernel of ``csrc/pyramid.cu`` for all the levels, at most ``MAX_LEVELS``
(``build_pyramid_cuda``), on the calling thread's current stream (built
with nvcc at first use into ``airdos_tpu_torch/_build/``, bound through
ctypes) or raises, and counts the launch, by thread and stream priority
too; on a CPU tensor it runs ``pyramid_level_ref`` level by level, the
plain composition of ops/filters.py's erode, resize_bilinear, the > 0.999
threshold and gaussian_blur7.  ``pyramid_level_cuda`` is one level in one
plain launch.  The two are bit-equal to the plain version.  The kernel
design and what bounds it are described at the top of the CUDA source;
``launch_grid`` and ``phase_plan`` are the cooperative launch's grid and
the tiles each of its blocks computes in each phase.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

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
_I32P = ctypes.POINTER(ctypes.c_int)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "airdos_pyramid_level": [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "airdos_pyramid_residency": [_I32P],
    "airdos_pyramid_levels": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    + [_I64P] * 3 + [_I32P] * 2 + [_F32P] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
}
MAX_ERODE = 16                   # the kernel's largest erosion window
MAX_LEVELS = 16                  # the all-levels launch's level table
TILE = 32                        # a block's output tile edge
BLOCKS_PER_SM = 2                # the cooperative grid's cap an SM
_MASK_KIND = {None: 0, torch.uint8: 1, torch.float32: 2}
_lib = None                      # the loaded library, once built
_residency = {}                  # device index -> (cooperative, SMs, blocks an SM)
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


def _library():
    global _lib
    if _lib is None:
        _lib = cuda_build.library(_SOURCE, _SIGNATURES)
        _lib.airdos_pyramid_error_name.argtypes = [ctypes.c_int]
        _lib.airdos_pyramid_error_name.restype = ctypes.c_char_p
    return _lib


def _error(err: int) -> str:
    return f"{_library().airdos_pyramid_error_name(err).decode()} ({err})"


def tiles(h: int, w: int) -> int:
    """The 32 x 32 tiles of an [h, w] level."""
    return -(-h // TILE) * -(-w // TILE)


def launch_grid(shapes: Sequence[Tuple[int, int]], sms: int,
                per_sm: int) -> int:
    """The cooperative launch's blocks: level 0's tiles (the most of any
    level), at most BLOCKS_PER_SM an SM and at most what the card holds at
    once (per_sm blocks of the kernel on each of its sms SMs)."""
    return max(1, min(tiles(*shapes[0]), BLOCKS_PER_SM * sms, per_sm * sms))


def phase_plan(shapes: Sequence[Tuple[int, int]],
               grid: int) -> List[List[List[Tuple[int, int]]]]:
    """plan[l][b]: the (y0, x0) of the tiles block b computes in phase l,
    as csrc/pyramid.cu's grid-stride loop takes them (tile t of a level
    lies at row t // tiles across, column t % tiles across); a grid
    barrier ends each phase but the last."""
    plan = []
    for h, w in shapes:
        across = -(-w // TILE)
        plan.append([[((t // across) * TILE, (t % across) * TILE)
                      for t in range(b, tiles(h, w), grid)]
                     for b in range(grid)])
    return plan


def _check_2d(name, x, dtypes, device=None):
    if not x.is_cuda or x.dtype not in dtypes or x.dim() != 2 \
            or not x.is_contiguous() or (device is not None
                                         and x.device != device):
        raise ValueError(f"{name} must be a contiguous CUDA [H, W] tensor of "
                         f"{', '.join(str(d) for d in dtypes)}"
                         f"{'' if device is None else f' on {device}'}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _check_erode(mask_erode: int) -> None:
    if not 1 <= mask_erode <= MAX_ERODE:
        raise ValueError(f"mask_erode {mask_erode}: the kernel erodes with "
                         f"a window of 1 to {MAX_ERODE} pixels")


def _scale(src: int, out: int) -> float:
    """resize_bilinear's float32 scale of a level of `out` pixels from one
    of `src`."""
    return float(np.float32(src / out))


def pyramid_level_cuda(src: torch.Tensor, src_mask: Optional[torch.Tensor],
                       out_h: int, out_w: int, level0: bool,
                       mask_erode: int = 10):
    """Launch the sm_90a kernel on the current stream for one level:
    pyramid_level_ref's (image, mask, blur)."""
    _check_2d("src", src, (torch.float32,))
    _check_erode(mask_erode)
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
    kernel = _library().airdos_pyramid_level
    dev = src.device
    img = src if level0 else torch.empty((out_h, out_w), dtype=torch.float32,
                                         device=dev)
    mask = torch.empty((out_h, out_w), dtype=torch.float32, device=dev)
    blur = torch.empty((out_h, out_w), dtype=torch.float32, device=dev)
    kind = _MASK_KIND[None if src_mask is None else src_mask.dtype]
    with cuda_build.on_device(dev):
        err = kernel(src.data_ptr(),
                     None if src_mask is None else src_mask.data_ptr(),
                     kind, hs, ws, None if level0 else img.data_ptr(),
                     mask.data_ptr(), blur.data_ptr(), out_h, out_w,
                     _scale(hs, out_h), _scale(ws, out_w), _TAPS, int(level0),
                     mask_erode, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pyramid kernel launch failed: {_error(err)}")
    _counter.count(cuda_build.stream_priority(dev))
    return img, mask, blur


def residency(device: torch.device) -> Tuple[int, int, int]:
    """(cudaDevAttrCooperativeLaunch, SMs, blocks of the all-levels kernel
    an SM holds at once) of a CUDA device, asked once a device."""
    found = _residency.get(device.index)
    if found is None:
        out = (ctypes.c_int * 3)()
        with cuda_build.on_device(device):
            err = _library().airdos_pyramid_residency(out)
        if err != 0:
            raise RuntimeError(f"pyramid: the device query failed: "
                               f"{_error(err)}")
        found = _residency[device.index] = tuple(out)
    return found


def cooperative_grid(device: torch.device,
                     shapes: Sequence[Tuple[int, int]]) -> int:
    """The all-levels launch's grid on `device` (launch_grid); raises where
    the device cannot launch a cooperative grid."""
    cooperative, sms, per_sm = residency(device)
    if not cooperative:
        raise RuntimeError(f"pyramid: {device} has no cooperative launch "
                           f"(cudaDevAttrCooperativeLaunch 0), which the "
                           f"all-levels kernel's grid barrier needs")
    if per_sm < 1:
        raise RuntimeError(f"pyramid: no block of the all-levels kernel "
                           f"fits an SM of {device}")
    return launch_grid(shapes, sms, per_sm)


def _levels(img: torch.Tensor, shapes):
    """The levels' (images, masks, blurs): views into one flat buffer,
    level 0's image the input itself."""
    n = len(shapes)
    views = cuda_build.level_views(list(shapes[1:]) + list(shapes) * 2,
                                   img.device)
    return (img,) + views[:n - 1], views[n - 1:2 * n - 1], views[2 * n - 1:]


def build_pyramid_cuda(img: torch.Tensor, mask: Optional[torch.Tensor],
                       n_levels: int = 8, scale_factor: float = 1.2,
                       mask_erode: int = 10) -> Pyramid:
    """Launch the sm_90a kernel on the current stream for every level at
    once (a cooperative launch; raises if the device cannot make it)."""
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"{n_levels} levels: the kernel builds 1 to "
                         f"{MAX_LEVELS}")
    _check_erode(mask_erode)
    _check_2d("img", img, (torch.float32,))
    dev = img.device
    if mask is not None:
        _check_2d("mask", mask, (torch.uint8, torch.float32), dev)
        if mask.shape != img.shape:
            raise ValueError(f"mask {tuple(mask.shape)} for img "
                             f"{tuple(img.shape)}")
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale_factor)
    if min(min(s) for s in shapes) < 4:
        raise ValueError(f"levels {shapes}: the blur's reflect border needs "
                         f"4 pixels a side")
    if h * w >= 2 ** 31:
        raise ValueError(f"{h}x{w} image exceeds the kernel's indexing")
    kernel = _library().airdos_pyramid_levels
    grid = cooperative_grid(dev, shapes)
    images, masks, blurs = _levels(img, shapes)

    def ptrs(xs):
        return (ctypes.c_int64 * n_levels)(*(x.data_ptr() for x in xs))

    def ints(vals):
        return (ctypes.c_int * n_levels)(*vals)

    def scales(axis):
        return (ctypes.c_float * n_levels)(1.0, *(
            _scale(a[axis], b[axis]) for a, b in zip(shapes, shapes[1:])))

    with cuda_build.on_device(dev):
        err = kernel(img.data_ptr(),
                     None if mask is None else mask.data_ptr(),
                     _MASK_KIND[None if mask is None else mask.dtype],
                     ptrs(images), ptrs(masks), ptrs(blurs),
                     ints(s[0] for s in shapes), ints(s[1] for s in shapes),
                     scales(0), scales(1), n_levels, mask_erode, _TAPS, grid,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pyramid kernel launch failed: {_error(err)}")
    _counter.count(cuda_build.stream_priority(dev))
    return Pyramid(images, masks, blurs,
                   tuple(scale_factor ** lvl for lvl in range(n_levels)))


def build_pyramid(img: torch.Tensor,
                  mask: Optional[torch.Tensor],
                  n_levels: int = 8,
                  scale_factor: float = 1.2,
                  mask_erode: int = 10) -> Pyramid:
    """img: [H, W] float32.  mask: [H, W] with 1 = usable pixel, or None
    for no masking; it is eroded mask_erode x mask_erode (1 to MAX_ERODE
    on the card) before level 0.  CUDA tensors go to the kernel (one
    launch), CPU tensors to the plain version, level by level."""
    if img.is_cuda:
        return build_pyramid_cuda(img, mask, n_levels, scale_factor,
                                  mask_erode)
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale_factor)
    images, masks, blurs = _levels(img, shapes)
    src, src_mask = img, mask
    for lvl, (hl, wl) in enumerate(shapes):
        im, m, b = pyramid_level_ref(src, src_mask, hl, wl, lvl == 0,
                                     mask_erode)
        if lvl:
            images[lvl].copy_(im)
        masks[lvl].copy_(m)
        blurs[lvl].copy_(b)
        src, src_mask = images[lvl], masks[lvl]
    return Pyramid(images, masks, blurs,
                   tuple(scale_factor ** lvl for lvl in range(n_levels)))
