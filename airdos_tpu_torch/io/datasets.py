"""Dataset records and the text readers of the sequence layouts.

The per-frame input record of the tracking API, and the numpy text
readers of airdos_tpu/io/datasets.py (TartanAir-Shibuya layout: AlphaPose
detections, track ids, ground-truth poses; reference
Examples/Stereo/stereo_human.cc, System.cc:496-528).  The image sequence
readers (TartanAir, KITTI, EuRoC) read PNGs with OpenCV and are not part
of this port yet (ROADMAP port queue: dataset image readers).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np


def read_number_txt(path: str | Path, cols: Optional[int] = None) -> np.ndarray:
    """Whitespace matrix loader (reference: System_utils.h read_number_txt).
    Returns [0, cols] when the file is missing or empty (the reference's
    recovery)."""
    p = Path(path)
    if not p.exists():
        return np.zeros((0, cols or 0))
    try:
        data = np.loadtxt(p, ndmin=2)
    except ValueError:
        return np.zeros((0, cols or 0))
    if data.size == 0:
        return np.zeros((0, cols or 0))
    if cols is not None and data.shape[1] != cols:
        data = data.reshape(-1, cols)
    return data


def read_alphapose_file(path: str | Path) -> np.ndarray:
    """One AlphaPose file -> [n_humans, 18, 3] (x, y, score)."""
    return read_number_txt(path, 54).reshape(-1, 18, 3)


def read_track_ids(path: str | Path) -> np.ndarray:
    """One track-id file -> [n_humans] int."""
    return read_number_txt(path, 1).reshape(-1).astype(np.int64)


def read_ground_truth_poses(path: str | Path) -> np.ndarray:
    """8-column ground truth ``time tx ty tz qw qx qy qz`` (as read by
    System::ReadGroundTruthPoses) -> raw [N, 8]."""
    return read_number_txt(path, 8)


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
