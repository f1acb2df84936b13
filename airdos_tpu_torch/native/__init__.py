"""The map bookkeeping's integer host work, in numpy.

The counterpart of airdos_tpu/native/ (airdos_native.cpp, a CPython
extension built by tools/build_native.sh), with its four functions and
their results:

- ``distinctive_descriptor(descs)``: the index of a point's distinctive
  descriptor among its observations' (MapPoint::ComputeDistinctiveDescriptors,
  reference src/MapPoint.cc:245-310): the first row whose median Hamming
  distance to the others, element (N - 1) // 2 of its sorted distance row,
  is the smallest; -1 for no row;
- ``distinctive_descriptors_batch(descs, offsets)``: the same for many
  points at once, point k's rows being offsets[k]:offsets[k + 1]; the
  winners as absolute rows, -1 for a point with no row.  The points are
  grouped by their number of rows n, and each group takes one xor and
  popcount (``np.bitwise_count``) over [g, n, n, 4] 64-bit words, one
  partition of the distance rows and one first-minimum argmin (at most
  ~4 MB of xor words a step);
- ``covisibility_counts(point_kf_lists, self_id)``: how many of a
  keyframe's points each other keyframe observes (KeyFrame::
  UpdateConnections' counting, reference src/KeyFrame.cc:305);
- ``hamming_matrix_u8(a, b)``: all-pairs Hamming distances.

Descriptors are uint8 [N, 32] rows (the port's uint32 [N, 8] words viewed
as bytes).  As in airdos_tpu, SlamMap calls the two descriptor functions
and nothing calls the other two: update_connections keeps its own
counting, whose tie order it depends on.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

_STEP_BYTES = 1 << 22            # xor bytes a group step takes at most


def _words(descs: np.ndarray, what: str) -> np.ndarray:
    """uint8 [N, 32] descriptors -> their uint64 [N, 4] words."""
    descs = np.asarray(descs)
    if descs.dtype != np.uint8 or descs.ndim != 2 or descs.shape[1] != 32:
        raise ValueError(f"{what} must be uint8 [N, 32], got {descs.dtype} "
                         f"{descs.shape}")
    return np.ascontiguousarray(descs).view(np.uint64)


def _distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Hamming distances int32 of word rows a [..., 4] and b [..., 4]."""
    return np.bitwise_count(a ^ b).sum(axis=-1, dtype=np.int32)


def _winners(blocks: np.ndarray) -> np.ndarray:
    """[g, n, 4] uint64 -> [g] int64: each block's first row of least
    median distance."""
    n = blocks.shape[1]
    dist = _distances(blocks[:, :, None], blocks[:, None, :])   # [g, n, n]
    med = np.partition(dist, (n - 1) // 2, axis=-1)[..., (n - 1) // 2]
    return np.argmin(med, axis=1)


def distinctive_descriptors_batch(descs: np.ndarray,
                                  offsets: np.ndarray) -> np.ndarray:
    """descs uint8 [M, 32], offsets int64 [K + 1] -> int64 [K]: point k's
    winning row (absolute), -1 where it has none."""
    words = _words(descs, "descs")
    offsets = np.asarray(offsets)
    if offsets.dtype != np.int64 or offsets.ndim != 1 or offsets.size < 1:
        raise ValueError(f"offsets must be int64 [K + 1], got "
                         f"{offsets.dtype} {offsets.shape}")
    lo, counts = offsets[:-1], np.diff(offsets)
    out = np.full(lo.shape[0], -1, np.int64)
    for n in np.unique(counts[counts > 0]):
        n = int(n)
        points = np.nonzero(counts == n)[0]
        step = max(1, _STEP_BYTES // (32 * n * n))
        for i in range(0, points.size, step):
            chunk = points[i:i + step]
            rows = lo[chunk, None] + np.arange(n)                # [g, n]
            out[chunk] = lo[chunk] + _winners(words[rows])
    return out


def distinctive_descriptor(descs: np.ndarray) -> int:
    """descs uint8 [N, 32] -> the winning row, -1 for N = 0."""
    words = _words(descs, "descs")
    if words.shape[0] == 0:
        return -1
    return int(_winners(words[None])[0])


def covisibility_counts(point_kf_lists: List[np.ndarray],
                        self_id: int) -> Dict[int, int]:
    """{keyframe id: how many of the lists name it}, self_id left out;
    each list holds the ids of the keyframes observing one point."""
    if not isinstance(point_kf_lists, list):
        raise TypeError("expected a list of int64 arrays")
    for ids in point_kf_lists:
        if not isinstance(ids, np.ndarray) or ids.dtype != np.int64:
            raise TypeError("entries must be int64 ndarrays")
    if not point_kf_lists:
        return {}
    ids = np.concatenate([a.ravel() for a in point_kf_lists])
    keys, counts = np.unique(ids[ids != self_id], return_counts=True)
    return {int(k): int(c) for k, c in zip(keys, counts)}


def hamming_matrix_u8(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a uint8 [N, 32], b uint8 [M, 32] -> int32 [N, M] distances."""
    return _distances(_words(a, "a")[:, None], _words(b, "b")[None])
