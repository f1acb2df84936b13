"""ORB feature extraction over a pyramid.

Behavioral rebuild of the reference's ORBextractor::operator()
(ORBextractor.cc:1054-1119), in the shape-static form of airdos_tpu:
dense FAST scores -> strict NMS -> best corner per grid cell ->
round-robin across 4x4-cell blocks -> top-K per level quota -> IC angle ->
Gaussian blur -> rBRIEF -> coordinates rescaled to level 0.  Every level
yields exactly its quota of padded slots, and the slot count is padded to
a multiple of 128 so slot layouts line up with the JAX package.

The pyramid (ops/pyramid.build_pyramid) brings each level's blur.  The
detection maps of all levels (scores, mask, border, threshold, NMS) are
one ``ops/fast.fast_nms_levels`` call, the keypoint selection of all
levels one ``ops/select.select_keypoints`` call, and the angles and
descriptors of all levels one ``ops/orb_kernels.orb_describe_levels``
call: a kernel launch each on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from airdos_tpu_torch.ops.brief import pack_u32
from airdos_tpu_torch.ops.fast import fast_nms_levels
from airdos_tpu_torch.ops.orb_kernels import orb_describe_levels
from airdos_tpu_torch.ops.select import select_keypoints

# Keypoint coordinates live in [EDGE, dim - EDGE) at each level, like the
# reference's EDGE_THRESHOLD=19 with FAST pattern margin 3 (minBorder = 16).
MIN_BORDER = 16


class OrbFeatures(NamedTuple):
    xy: torch.Tensor        # [N, 2] float32, level-0 pixel coords
    response: torch.Tensor  # [N] float32 FAST score
    angle: torch.Tensor     # [N] float32 degrees [0, 360)
    octave: torch.Tensor    # [N] int64 pyramid level
    desc: torch.Tensor      # [N, 32] uint8 (cv2-compatible layout)
    desc32: torch.Tensor    # [N, 8] int32 bit views of the uint32 words
    valid: torch.Tensor     # [N] bool


def level_quotas(n_features: int, n_levels: int, scale_factor: float) -> Tuple[int, ...]:
    """Per-level feature budget, geometric split like the reference
    (ORBextractor.cc constructor): level l gets ~ n * (1/f)^l, normalized."""
    inv = 1.0 / scale_factor
    first = n_features * (1 - inv) / (1 - inv ** n_levels)
    quotas = [int(round(first * inv ** l)) for l in range(n_levels - 1)]
    quotas.append(max(0, n_features - sum(quotas)))
    return tuple(quotas)


def _cell_size_for(h: int, w: int, quota: int) -> int:
    """Static cell size giving at least ~2x quota cells (min 8 px)."""
    if quota <= 0:
        return max(8, min(h, w))
    target_cells = 2 * quota
    cs = int(np.sqrt(h * w / target_cells))
    return int(np.clip(cs, 8, 64))


class OrbExtractor:
    """Per-level ORB extraction with the reference's budget split."""

    def __init__(self, n_features: int = 1500, scale_factor: float = 1.2,
                 n_levels: int = 8, ini_th: int = 12, min_th: int = 7):
        self.n_features = n_features
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.ini_th = float(ini_th)
        self.min_th = float(min_th)
        self.quotas = level_quotas(n_features, n_levels, scale_factor)
        self._slot_tables = {}      # device -> (scale, octave) a slot

    @property
    def scales(self) -> Tuple[float, ...]:
        return tuple(self.scale_factor ** l for l in range(self.n_levels))

    @property
    def sigma2(self) -> np.ndarray:
        """Per-level measurement variance (scale^2), reference mvLevelSigma2."""
        return np.asarray([s * s for s in self.scales], np.float32)

    def _slots_on(self, device):
        """Per slot, the float32 scale of its level (level-0 coordinates
        are the level's times it, as a float32 multiply by the level's
        scale_factor ** level rounds) and its level, made once a device."""
        tables = self._slot_tables.get(device)
        if tables is None:
            counts = torch.tensor(self.quotas)
            scale = torch.repeat_interleave(
                torch.tensor(self.scales, dtype=torch.float32), counts)
            octv = torch.repeat_interleave(torch.arange(self.n_levels), counts)
            tables = self._slot_tables[device] = (scale.to(device),
                                                  octv.to(device))
        return tables

    def _extract_from_pyramid(self, pyr) -> OrbFeatures:
        maps = fast_nms_levels(pyr.images, pyr.masks, self.min_th,
                               MIN_BORDER)
        cells = [_cell_size_for(h - 2 * MIN_BORDER, w - 2 * MIN_BORDER, q)
                 for (h, w), q in zip((x.shape for x in pyr.images),
                                      self.quotas)]
        xs_all, ys_all, resp = select_keypoints(maps, self.quotas, cells,
                                                self.ini_th)
        ang, words = orb_describe_levels(pyr.images, pyr.blurred, xs_all,
                                         ys_all, self.quotas)
        desc = words.view(torch.uint8)              # [N, 32], pack_u32's bytes
        scale, octv = self._slots_on(xs_all.device)
        xy = torch.stack([xs_all.to(torch.float32), ys_all.to(torch.float32)],
                         dim=-1) * scale[:, None]
        # slot count padded to a multiple of 128, as in airdos_tpu (whose
        # Pallas tile needs it), so slot layouts line up between the two
        pad = (-xy.shape[0]) % 128
        if pad:
            xy = F.pad(xy, (0, 0, 0, pad))
            resp = F.pad(resp, (0, pad))
            ang = F.pad(ang, (0, pad))
            octv = F.pad(octv, (0, pad))
            desc = F.pad(desc, (0, 0, 0, pad))
        valid = resp > 0
        return OrbFeatures(xy=xy, response=resp, angle=ang, octave=octv,
                           desc=desc, desc32=pack_u32(desc), valid=valid)
