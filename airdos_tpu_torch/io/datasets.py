"""Dataset records.

The per-frame input record of the tracking API.  The dataset readers of
the JAX package (TartanAir, KITTI, EuRoC layouts) are not part of this
port yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class FrameData:
    """Everything one tracked frame consumes."""
    timestamp: float
    index: int
    image_left: np.ndarray                 # [H, W] float32 grayscale 0..255
    image_right: np.ndarray
    seg_left: Optional[np.ndarray] = None  # [H, W] uint8 (0 = static)
    seg_right: Optional[np.ndarray] = None
    depth: Optional[np.ndarray] = None
    humans_left: Optional[np.ndarray] = None   # [nL, 18, 3]
    humans_right: Optional[np.ndarray] = None  # [nR, 18, 3]
    track_ids: Optional[np.ndarray] = None     # [nL]
