"""Stereo rectification maps and bilinear remapping in numpy.

The counterparts of the two OpenCV calls airdos_tpu's EuRoC reader makes
(reference Examples/Stereo/stereo_euroc.cc:71-107):

- ``init_undistort_rectify_map(K, D, R, P33, (w, h))``:
  ``cv2.initUndistortRectifyMap(K, D, R, P33, (w, h), cv2.CV_32F)``: for
  every rectified pixel, the raw image's coordinates, through inv(P33 R)
  and the plumb-bob distortion (k1, k2, p1, p2[, k3]), computed in float64
  and returned as two float32 maps;
- ``remap_linear(img, map_x, map_y)``: ``cv2.remap(img, map_x, map_y,
  cv2.INTER_LINEAR)`` on uint8 images as OpenCV 4.11 and later compute
  it: in float32 from the map's own coordinates (two lerps along x, one
  along y), rounded to nearest, and taps outside the image read as 0
  (BORDER_CONSTANT).  Earlier OpenCV releases rounded the coordinates to
  1/32 px and summed 15-bit integer weights; on noise images their
  results differ from these by up to 7 grey levels.

D with more than five terms (the rational, thin-prism and tilted models)
is refused: the reference's EuRoC.yaml gives five.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def init_undistort_rectify_map(K, D, R, P33, size: Tuple[int, int]):
    """(map_x, map_y), float32 [h, w]: where rectified pixel (u, v) lies in
    the raw image of camera matrix K and distortion D, for the
    rectifying rotation R and the new camera matrix P33; size is
    (w, h)."""
    K = np.asarray(K, np.float64).reshape(3, 3)
    d = np.asarray(D, np.float64).reshape(-1)
    if d.size not in (0, 4, 5):
        raise ValueError(f"distortion with {d.size} terms: only the "
                         f"plumb-bob model (k1, k2, p1, p2[, k3]) is "
                         f"supported")
    k1, k2, p1, p2, k3 = np.concatenate([d, np.zeros(5 - d.size)])
    iR = np.linalg.inv(np.asarray(P33, np.float64).reshape(3, 3)
                       @ np.asarray(R, np.float64).reshape(3, 3))
    w, h = size
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    X = iR[0, 0] * u + iR[0, 1] * v + iR[0, 2]
    Y = iR[1, 0] * u + iR[1, 1] * v + iR[1, 2]
    W = iR[2, 0] * u + iR[2, 1] * v + iR[2, 2]
    x, y = X / W, Y / W
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    xy2 = 2.0 * x * y
    kr = 1.0 + ((k3 * r2 + k2) * r2 + k1) * r2
    map_x = K[0, 0] * (x * kr + p1 * xy2 + p2 * (r2 + 2.0 * x2)) + K[0, 2]
    map_y = K[1, 1] * (y * kr + p1 * (r2 + 2.0 * y2) + p2 * xy2) + K[1, 2]
    return map_x.astype(np.float32), map_y.astype(np.float32)


def remap_linear(img: np.ndarray, map_x: np.ndarray,
                 map_y: np.ndarray) -> np.ndarray:
    """cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR) for a uint8 [H, W]
    image and float32 maps: the output has the maps' shape."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"remap_linear takes a uint8 [H, W] image, got "
                         f"{img.dtype} {img.shape}")
    mx = np.asarray(map_x, np.float32)
    my = np.asarray(map_y, np.float32)
    fx, fy = np.floor(mx), np.floor(my)
    alpha, beta = mx - fx, my - fy
    h, w = img.shape
    lim = float(2 ** 30)
    x0 = np.clip(fx, -lim, lim).astype(np.int64)
    y0 = np.clip(fy, -lim, lim).astype(np.int64)
    # a border of one zero pixel holds every tap of a pixel whose square
    # touches the image; a square wholly outside it reads 0
    padded = np.zeros((h + 2, w + 2), np.float32)
    padded[1:-1, 1:-1] = img
    inside = (x0 >= -1) & (x0 < w) & (y0 >= -1) & (y0 < h)
    xi = np.where(inside, x0 + 1, 0)
    yi = np.where(inside, y0 + 1, 0)
    p00, p01 = padded[yi, xi], padded[yi, xi + 1]
    p10, p11 = padded[yi + 1, xi], padded[yi + 1, xi + 1]
    # OpenCV's order of float32 operations: two lerps along x, one along y,
    # rounded to nearest, ties to even
    top = p00 + alpha * (p01 - p00)
    bottom = p10 + alpha * (p11 - p10)
    v = top + beta * (bottom - top)
    return np.where(inside, np.clip(np.rint(v), 0, 255), 0).astype(np.uint8)
