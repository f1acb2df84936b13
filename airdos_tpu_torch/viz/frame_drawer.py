"""2-D tracking overlay (reference: FrameDrawer, src/FrameDrawer.cc:39-160).

Renders the current frame's grayscale image with per-keypoint markers
(green boxes for map-point matches, blue for visual-odometry (temporal)
points, red crosses for human joints) and a status text bar, as an RGB
numpy image, pixel for pixel as airdos_tpu/viz/frame_drawer.py does.
Host numpy only, off the device path; matplotlib is imported only to
write a non-PPM file.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

GREEN = np.array([40, 220, 60], np.uint8)
BLUE = np.array([80, 120, 255], np.uint8)
RED = np.array([230, 60, 50], np.uint8)
WHITE = np.array([255, 255, 255], np.uint8)

# 5x7 bitmap font for the status bar (digits, upper-case, few symbols)
_GLYPHS = {}


def _glyph(ch: str) -> np.ndarray:
    if not _GLYPHS:
        data = {
            "0": "111101101101111", "1": "010110010010111",
            "2": "111001111100111", "3": "111001111001111",
            "4": "101101111001001", "5": "111100111001111",
            "6": "111100111101111", "7": "111001001001001",
            "8": "111101111101111", "9": "111101111001111",
            "K": "101110100110101", "F": "111100110100100",
            "M": "101111111101101", "P": "111101111100100",
            "T": "111010010010010", "R": "111101110110101",
            "A": "111101111101101", "C": "111100100100111",
            "L": "100100100100111", "O": "111101101101111",
            "S": "111100111001111", "E": "111100110100111",
            "I": "111010010010111", "N": "101111111111101",
            "D": "110101101101110", "U": "101101101101111",
            "G": "111100101101111", "H": "101101111101101",
            ":": "000010000010000", " ": "000000000000000",
            "=": "000111000111000", "-": "000000111000000",
        }
        for c, bits in data.items():
            _GLYPHS[c] = np.asarray([int(b) for b in bits],
                                    np.uint8).reshape(5, 3)
    return _GLYPHS.get(ch.upper(), _GLYPHS[" "])


def _draw_text(img: np.ndarray, text: str, x: int, y: int,
               color=WHITE, scale: int = 2):
    h, w = img.shape[:2]
    for ch in text:
        g = np.kron(_glyph(ch), np.ones((scale, scale), np.uint8))
        gh, gw = g.shape
        if y + gh >= h or x + gw >= w:
            break
        region = img[y:y + gh, x:x + gw]
        region[g > 0] = color
        x += gw + scale


def _box(img, u, v, r, color):
    h, w = img.shape[:2]
    u0, u1 = max(0, u - r), min(w - 1, u + r)
    v0, v1 = max(0, v - r), min(h - 1, v + r)
    img[v0, u0:u1 + 1] = color
    img[v1, u0:u1 + 1] = color
    img[v0:v1 + 1, u0] = color
    img[v0:v1 + 1, u1] = color


def _cross(img, u, v, r, color):
    h, w = img.shape[:2]
    if 0 <= v < h:
        img[v, max(0, u - r):min(w, u + r + 1)] = color
    if 0 <= u < w:
        img[max(0, v - r):min(h, v + r + 1), u] = color


def draw_frame(frame, state_name: str = "OK",
               n_keyframes: int = 0, n_points: int = 0,
               image: Optional[np.ndarray] = None) -> np.ndarray:
    """Returns an RGB uint8 overlay image for one tracked frame.

    frame: slam.frame.Frame (uses xy, mp_idx, outlier, humans).
    image: the grayscale image (H, W); if None a black canvas is used.
    """
    if image is not None:
        g = np.clip(np.asarray(image), 0, 255).astype(np.uint8)
    else:
        h = int(frame.camera.height if hasattr(frame, "camera") else 480)
        w = int(frame.camera.width if hasattr(frame, "camera") else 640)
        g = np.zeros((h, w), np.uint8)
    img = np.stack([g, g, g], axis=-1)

    n_map = n_vo = 0
    xy = frame.xy
    for fid in np.nonzero((frame.mp_idx != -1) & frame.valid)[0]:
        if frame.outlier[fid]:
            continue
        u, v = int(round(xy[fid, 0])), int(round(xy[fid, 1]))
        if frame.mp_idx[fid] >= 0:
            _box(img, u, v, 3, GREEN)
            n_map += 1
        else:                       # VO (temporal) association, coded <= -2
            _box(img, u, v, 3, BLUE)
            n_vo += 1
    for obs in getattr(frame, "humans", []):
        for j in range(obs.kp_left.shape[0]):
            if obs.bad[j]:
                continue
            _cross(img, int(round(obs.kp_left[j, 0])),
                   int(round(obs.kp_left[j, 1])), 3, RED)

    bar_h = 22
    img[-bar_h:] = (img[-bar_h:] * 0.25).astype(np.uint8)
    txt = (f"{state_name}  KFS:{n_keyframes} MPS:{n_points} "
           f"MATCHES:{n_map}")
    if n_vo:
        txt += f" VO:{n_vo}"
    _draw_text(img, txt, 6, img.shape[0] - bar_h + 4)
    return img


def save_frame_overlay(path: str, frame, state_name: str = "OK",
                       n_keyframes: int = 0, n_points: int = 0,
                       image: Optional[np.ndarray] = None):
    img = draw_frame(frame, state_name, n_keyframes, n_points, image)
    if str(path).endswith(".ppm"):
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
            f.write(img.tobytes())
    else:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.imsave(path, img)
    return img
