"""ORB feature extraction over a pyramid.

Behavioral rebuild of the reference's ORBextractor::operator()
(ORBextractor.cc:1054-1119), in the shape-static form of airdos_tpu:
dense FAST scores -> strict NMS -> best corner per grid cell ->
round-robin across 4x4-cell blocks -> top-K per level quota -> IC angle ->
Gaussian blur -> rBRIEF -> coordinates rescaled to level 0.  Every level
yields exactly its quota of padded slots, and the slot count is padded to
a multiple of 128 so slot layouts line up with the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from airdos_tpu_torch.ops.brief import compute_descriptors, pack_u32
from airdos_tpu_torch.ops.fast import fast_score_map, nms_strict
from airdos_tpu_torch.ops.filters import gaussian_blur7
from airdos_tpu_torch.ops.orientation import keypoint_angles

# Keypoint coordinates live in [EDGE, dim - EDGE) at each level, like the
# reference's EDGE_THRESHOLD=19 with FAST pattern margin 3 (minBorder = 16).
MIN_BORDER = 16
INI_BOOST = 1000.0     # selection boost for corners passing the high threshold


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


def _top_k_lower_index_first(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, ties broken toward the lower index
    (jax.lax.top_k's order; torch.topk documents none)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def _select_level_keypoints(score: torch.Tensor, quota: int, cell: int,
                            ini_th: float, min_th: float):
    """NMS + per-cell best + spatially fair top-K.  Returns xs, ys [quota]
    int64 and response [quota] float32 (0 response = invalid slot)."""
    h, w = score.shape
    dev = score.device
    zero = torch.zeros_like(score)
    s = nms_strict(torch.where(score > min_th, score, zero))
    sel = torch.where(s > ini_th, s + INI_BOOST, s)

    ncy, ncx = -(-h // cell), -(-w // cell)
    sp = F.pad(sel, (0, ncx * cell - w, 0, ncy * cell - h))
    cells = sp.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3) \
              .reshape(ncy, ncx, cell * cell)
    best_score, best_in_cell = torch.max(cells, dim=-1)
    cy = torch.arange(ncy, device=dev)[:, None]
    cx = torch.arange(ncx, device=dev)[None, :]
    ys_cell = cy * cell + best_in_cell // cell
    xs_cell = cx * cell + best_in_cell % cell

    # Spatially fair selection (the quadtree's guarantee, reference
    # ORBextractor::DistributeOctTree): rank cells by response within
    # 4x4-cell blocks, then take every block's best cell before any
    # block's second-best.
    BY = BX = 4
    nby, nbx = -(-ncy // BY), -(-ncx // BX)
    bs = F.pad(best_score, (0, nbx * BX - ncx, 0, nby * BY - ncy))
    blocks = bs.reshape(nby, BY, nbx, BX).permute(0, 2, 1, 3) \
               .reshape(nby * nbx, BY * BX)
    order = torch.sort(-blocks, dim=-1, stable=True).indices
    ranks = torch.empty_like(order).scatter_(
        1, order, torch.arange(BY * BX, device=dev).expand(order.shape).contiguous())
    ranks = torch.where(blocks > 0, ranks, torch.full_like(ranks, BY * BX))
    ranks = ranks.reshape(nby, nbx, BY, BX).permute(0, 2, 1, 3) \
                 .reshape(nby * BY, nbx * BX)[:ncy, :ncx]
    key = best_score - ranks.to(best_score.dtype) * (2.0 * INI_BOOST)

    flat_key = key.reshape(-1)
    k = min(quota, flat_key.shape[0])
    top_idx = _top_k_lower_index_first(flat_key, k)
    top_scores = best_score.reshape(-1)[top_idx]
    xs = xs_cell.reshape(-1)[top_idx]
    ys = ys_cell.reshape(-1)[top_idx]
    resp = torch.where(top_scores > 0, torch.remainder(top_scores, INI_BOOST),
                       torch.zeros_like(top_scores))
    if k < quota:
        pad = quota - k
        xs = F.pad(xs, (0, pad))
        ys = F.pad(ys, (0, pad))
        resp = F.pad(resp, (0, pad))
    return xs, ys, resp


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

    @property
    def scales(self) -> Tuple[float, ...]:
        return tuple(self.scale_factor ** l for l in range(self.n_levels))

    @property
    def sigma2(self) -> np.ndarray:
        """Per-level measurement variance (scale^2), reference mvLevelSigma2."""
        return np.asarray([s * s for s in self.scales], np.float32)

    def _extract_from_pyramid(self, pyr) -> OrbFeatures:
        out_xy, out_resp, out_ang, out_oct, out_desc = [], [], [], [], []
        for lvl in range(self.n_levels):
            im = pyr.images[lvl]
            m = pyr.masks[lvl]
            h, w = im.shape
            quota = self.quotas[lvl]
            score = fast_score_map(im) * m
            inside = torch.zeros_like(score)
            inside[MIN_BORDER:h - MIN_BORDER, MIN_BORDER:w - MIN_BORDER] = 1.0
            score = torch.where(inside > 0, score, torch.zeros_like(score))

            cell = _cell_size_for(h - 2 * MIN_BORDER, w - 2 * MIN_BORDER, quota)
            xs, ys, resp = _select_level_keypoints(
                score, quota, cell, self.ini_th, self.min_th)

            ang = keypoint_angles(im, xs, ys)
            blurred = gaussian_blur7(im)
            desc = compute_descriptors(blurred, xs, ys, ang)

            scale = self.scale_factor ** lvl
            xy0 = torch.stack([xs.to(torch.float32), ys.to(torch.float32)],
                              dim=-1) * scale
            out_xy.append(xy0)
            out_resp.append(resp)
            out_ang.append(ang)
            out_oct.append(torch.full((quota,), lvl, dtype=torch.int64,
                                      device=im.device))
            out_desc.append(desc)

        xy = torch.cat(out_xy, dim=0)
        resp = torch.cat(out_resp, dim=0)
        ang = torch.cat(out_ang, dim=0)
        octv = torch.cat(out_oct, dim=0)
        desc = torch.cat(out_desc, dim=0)
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
