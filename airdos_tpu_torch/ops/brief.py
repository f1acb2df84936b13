"""Steered-BRIEF (rBRIEF) 256-bit descriptors.

The standard learned ORB sampling pattern (``bit_pattern_31`` of the ORB
paper and OpenCV, stored as orb_pattern.npy, byte-equal to airdos_tpu's
copy) keeps descriptors bit-compatible with the reference's
computeOrbDescriptor (ORBextractor.cc:109-148) and with cv2.ORB.

All 512 pattern points are rotated for all N keypoints at once, the
blurred level is sampled at the N x 512 points (the semantics of
airdos_tpu's ``_samples_gather``), the 256 pairs are compared and the
bits packed.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch


@functools.lru_cache(maxsize=1)
def load_pattern() -> np.ndarray:
    """[256, 4] int32: (x0, y0, x1, y1) per descriptor bit."""
    return np.load(Path(__file__).parent / "orb_pattern.npy")


def compute_descriptors(img_blur: torch.Tensor,
                        xs: torch.Tensor, ys: torch.Tensor,
                        angles_deg: torch.Tensor) -> torch.Tensor:
    """img_blur [H, W] f32 (the 7x7 sigma=2 blurred level); xs, ys [N]
    int64 keypoint coords at this level; angles_deg [N] f32.
    Returns uint8 [N, 32] (cv2-compatible byte layout)."""
    dev = img_blur.device
    pat = torch.as_tensor(load_pattern(), device=dev)
    px = torch.cat([pat[:, 0], pat[:, 2]]).to(torch.float32)    # [512]
    py = torch.cat([pat[:, 1], pat[:, 3]]).to(torch.float32)

    ang = torch.deg2rad(angles_deg)
    ca, sa = torch.cos(ang), torch.sin(ang)
    # cvRound is round-half-to-even, as torch.round
    dx = torch.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None]).to(torch.int64)
    dy = torch.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None]).to(torch.int64)

    h, w = img_blur.shape
    gx = torch.clamp(xs[:, None] + dx, 0, w - 1)                # [N, 512]
    gy = torch.clamp(ys[:, None] + dy, 0, h - 1)
    vals = img_blur[gy, gx]
    bits = (vals[:, :256] < vals[:, 256:]).to(torch.int32)      # [N, 256]
    # byte j, bit k from pair 8j + k
    shifts = torch.arange(8, dtype=torch.int32, device=dev)
    return torch.sum(bits.reshape(-1, 32, 8) << shifts, dim=-1).to(torch.uint8)


def pack_u32(desc_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [N, 32] -> [N, 8] little-endian 32-bit words, as int32 bit
    views of the uint32 words (torch has no uint32 shifts on CPU and no
    popcount; every consumer only XORs and counts bits)."""
    return desc_u8.contiguous().view(torch.int32)
