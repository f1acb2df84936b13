"""Image filters of the ORB front end.

GaussianBlur(7, 7, sigma=2, BORDER_REFLECT_101) before descriptor
extraction (reference ORBextractor.cc:1105), 10x10 erosion of the
segmentation mask for the mask pyramid (ORBextractor.cc:1121-1156), and
the cv2 INTER_LINEAR resize that builds pyramid levels.

The blur is shift-and-add in the JAX package's order of operations, not a
convolution: cuDNN would run a float32 conv in TF32 and move BRIEF
comparisons.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _gauss_kernel1d(ksize: int, sigma: float) -> tuple:
    """cv2.getGaussianKernel semantics, as float32 taps."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return tuple(float(v) for v in (k / k.sum()).astype(np.float32))


def _reflect_pad(img: torch.Tensor, top: int, bottom: int, left: int,
                 right: int) -> torch.Tensor:
    return F.pad(img[None, None], (left, right, top, bottom),
                 mode="reflect")[0, 0]


def gaussian_blur7(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Separable 7x7 Gaussian blur, BORDER_REFLECT_101.  img [H, W] f32."""
    k = _gauss_kernel1d(7, sigma)
    h, w = img.shape
    p = _reflect_pad(img, 0, 0, 3, 3)
    out = k[0] * p[:, 0:w]
    for i in range(1, 7):
        out = out + k[i] * p[:, i:i + w]
    p = _reflect_pad(out, 3, 3, 0, 0)
    out = k[0] * p[0:h, :]
    for i in range(1, 7):
        out = out + k[i] * p[i:i + h, :]
    return out


def erode(mask: torch.Tensor, ksize: int = 10) -> torch.Tensor:
    """Binary erosion with a ksize x ksize rectangle (cv2.erode semantics,
    anchor (k//2, k//2), border treated as 1).  mask [H, W], 1 = keep."""
    m = mask.to(torch.float32)
    lo = ksize // 2
    hi = ksize - 1 - lo
    p = F.pad(m[None, None], (lo, hi, lo, hi), value=1.0)
    return -F.max_pool2d(-p, ksize, stride=1)[0, 0]


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize matching cv2.resize(..., INTER_LINEAR) pixel-centre
    alignment: src = (dst + 0.5) * scale - 0.5."""
    h, w = img.shape
    sy = h / out_h
    sx = w / out_w
    ys = (torch.arange(out_h, dtype=torch.float32, device=img.device) + 0.5) * sy - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=img.device) + 0.5) * sx - 0.5
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy
