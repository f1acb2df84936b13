"""The tracking matchers' gate, reductions and uniqueness: CUDA kernels +
plain twins.

The stereo, motion-model, local-map and BoW matchers
(matching/stereo.py, matching/projection.py, matching/bow_match.py) each
compute, over rows (points or left keypoints) and columns (features or
right keypoints), the Hamming distance of every pair that passes a
gate, each row's best and second-best column, a threshold and ratio
test, then (all but stereo) a rotation-histogram filter and the
uniqueness resolution.  airdos_tpu reaches the Pallas Hamming kernel
there (airdos_tpu/ops/pallas_kernels.py:36) and leaves the rest to XLA;
here two kernels of ``csrc/match.cu`` do it all:

- ``match_rows`` (one launch a matcher call): gate, distances, best,
  second, the ratio test and, in stereo mode, the column argmin and the
  mutual check; no [P, N] matrix is written;
- ``match_resolve`` (one block): the rotation histogram's three largest
  bins and the uniqueness resolution.

Each wrapper, on CUDA tensors, launches its sm_90a kernel on the calling
thread's current stream (built with nvcc at first use into
``airdos_tpu_torch/_build/``, bound through ctypes) or raises, and counts
the launch, by thread and stream priority too; on CPU tensors it runs
the plain version (``match_rows_ref``, ``match_resolve_ref``): the eager
composition around the Hamming matrix the matchers had, so the CPU
results are theirs bit for bit.  The kernel's outputs equal the plain
version's bit for bit (the CUDA source says why).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from airdos_tpu_torch.ops import cuda_build
from airdos_tpu_torch.ops.hamming_kernels import hamming_matrix_ref

MOTION, LOCAL, STEREO, BOW = 0, 1, 2, 3     # the gate modes
BIG = 1 << 10                               # a pair outside the gate
HISTO_BINS = 30
INDEX_BITS = 21                             # rows and columns < 2^21
FAR_U = 1.5                                 # stereo: a second at another u
SECOND_CLAMP = 256                          # stereo: min(second, 256)


class MatchRows(NamedTuple):
    """The row side of a match (points, left keypoints or set 1)."""
    desc: torch.Tensor                      # [P, 8] int32
    key: torch.Tensor                       # [P] int64: octave or BoW node
    ok: torch.Tensor                        # [P] bool
    x: Optional[torch.Tensor] = None        # [P] float32 u (not bow)
    y: Optional[torch.Tensor] = None        # [P] float32 v (not bow)
    ur: Optional[torch.Tensor] = None       # [P] float32 (projection)
    radius: Optional[torch.Tensor] = None   # [P] float32 (projection)


class MatchCols(NamedTuple):
    """The column side (features, right keypoints or set 2)."""
    desc: torch.Tensor                      # [N, 8] int32
    key: torch.Tensor                       # [N] int64: octave or BoW node
    ok: torch.Tensor                        # [N] bool
    x: Optional[torch.Tensor] = None        # [N] float32 (not bow)
    y: Optional[torch.Tensor] = None        # [N] float32 (not bow)
    # projection: the feature's right u (gated where > 0); stereo: the
    # row band 2 * scale[octave]
    w: Optional[torch.Tensor] = None
    taken: Optional[torch.Tensor] = None    # [N] bool (projection)


class RowMatches(NamedTuple):
    best: torch.Tensor          # [P] int64 argmin column (0 where none)
    dist: torch.Tensor          # [P] int32 its distance (BIG where none)
    second: torch.Tensor        # [P] int64 the mode's second column
    second_dist: torch.Tensor   # [P] int32
    has: torch.Tensor           # [P] bool threshold and ratio (and mutual)
    col_best: torch.Tensor      # [N] int64 column argmin (stereo; else [0])


def gate(mode: int, rows: MatchRows, cols: MatchCols, band,
          max_d: float) -> torch.Tensor:
    """[P, N] bool: the matchers' gating, as they computed it."""
    if mode == BOW:
        return (rows.key[:, None] == cols.key[None, :]) & \
            rows.ok[:, None] & cols.ok[None, :] & \
            (rows.key >= 0)[:, None] & (cols.key >= 0)[None, :]
    if mode == STEREO:
        row_ok = torch.abs(rows.y[:, None] - cols.y[None, :]) <= \
            cols.w[None, :]
        oct_ok = torch.abs(rows.key[:, None] - cols.key[None, :]) <= 1
        disp = rows.x[:, None] - cols.x[None, :]
        disp_ok = (disp >= 0.0) & (disp <= max_d)
        return row_ok & oct_ok & disp_ok & rows.ok[:, None] & \
            cols.ok[None, :]
    r = rows.radius[:, None]
    du = torch.abs(cols.x[None, :] - rows.x[:, None])
    dv = torch.abs(cols.y[None, :] - rows.y[:, None])
    ok = (du < r) & (dv < r)
    lo, hi = band
    lf = cols.key[None, :]
    if lo is not None:
        ok = ok & (lf >= rows.key[:, None] + lo)
    if hi is not None:
        ok = ok & (lf <= rows.key[:, None] + hi)
    r_ok = torch.where(cols.w[None, :] > 0,
                       torch.abs(rows.ur[:, None] - cols.w[None, :]) < r,
                       torch.ones_like(ok))
    ok = ok & r_ok & rows.ok[:, None] & cols.ok[None, :]
    if cols.taken is not None:
        ok = ok & ~cols.taken[None, :]
    return ok


def reduce_gated(mode: int, D: torch.Tensor, col_key: torch.Tensor,
                 col_x, th: int, ratio: float) -> RowMatches:
    """The plain version's reductions of a gated distance matrix D [P, N]
    (int32, BIG outside the gate): best, the mode's second, the threshold
    and ratio test and, in stereo mode, the column argmin and the mutual
    check.  col_key: the columns' octaves (local mode's level test);
    col_x: their u (stereo's far-u second)."""
    P = D.shape[0]
    best = torch.argmin(D, dim=1)
    dist = torch.gather(D, 1, best[:, None])[:, 0]
    col_best = best.new_zeros(0)
    if mode == STEREO:
        # mutual consistency: the matched column's own best row must be
        # this one; ambiguity: a second column at a clearly different u
        col_best = torch.argmin(D, dim=0)
        far_u = torch.abs(col_x[None, :] - col_x[best][:, None]) > FAR_U
        D2 = torch.where(far_u, D, torch.full_like(D, BIG))
    else:
        D2 = D.clone()
        D2[torch.arange(P, device=D.device), best] = BIG
    second = torch.argmin(D2, dim=1)
    second_dist = torch.gather(D2, 1, second[:, None])[:, 0]
    has = dist <= th
    fb = dist.to(torch.float32)
    if mode == LOCAL:
        # best and second at one level: the ratio decides
        has = has & ~((col_key[best] == col_key[second]) &
                      (fb > ratio * second_dist.to(torch.float32)) &
                      (second_dist < BIG))
    elif mode == STEREO:
        mutual = col_best[best] == torch.arange(P, device=D.device)
        has = has & mutual & (fb < ratio * torch.clamp(
            second_dist, max=SECOND_CLAMP).to(torch.float32))
    elif mode == BOW:
        has = has & (fb < ratio * second_dist.to(torch.float32))
    return RowMatches(best=best, dist=dist, second=second,
                      second_dist=second_dist, has=has, col_best=col_best)


def match_rows_ref(mode: int, rows: MatchRows, cols: MatchCols, th: int,
                   ratio: float = 0.0, band=(None, None),
                   max_d: float = 0.0) -> RowMatches:
    """Plain version: the gated [P, N] distance matrix and its reductions,
    the matchers' eager composition.  th: the largest distance accepted;
    band: (lo, hi) octave offsets from the row's key (None: open), for the
    projection modes; max_d: stereo's largest disparity."""
    ok = gate(mode, rows, cols, band, max_d)
    D = hamming_matrix_ref(rows.desc, cols.desc)
    D = torch.where(ok, D, torch.full_like(D, BIG))
    return reduce_gated(mode, D, cols.key, cols.x, th, ratio)


def rotation_consistency(ang_ref, ang_cur, has):
    """Keep only matches in the 3 dominant rotation-histogram bins
    (ORBmatcher::ComputeThreeMaxima semantics, 1601-1645)."""
    rot = ang_ref - ang_cur
    rot = torch.where(rot < 0, rot + 360.0, rot)
    binf = torch.round(rot * (HISTO_BINS / 360.0))
    bins = torch.where(binf == HISTO_BINS, torch.zeros_like(binf), binf) \
        .to(torch.int64)
    bins = torch.clamp(bins, 0, HISTO_BINS - 1)
    counts = torch.zeros(HISTO_BINS, dtype=torch.int64, device=has.device)
    counts.index_add_(0, torch.where(has, bins, torch.zeros_like(bins)),
                      has.to(torch.int64))
    # top 3 bins, ties to the lower bin (jax.lax.top_k's order)
    top3 = torch.sort(counts, descending=True, stable=True)
    top3_vals, top3_idx = top3.values[:3], top3.indices[:3]
    # the reference drops bins with count < 0.1 * max
    ok = top3_vals.to(torch.float32) >= 0.1 * top3_vals[0].to(torch.float32)
    keep_bin = torch.zeros(HISTO_BINS, dtype=torch.bool, device=has.device)
    keep_bin[top3_idx] = ok
    return has & keep_bin[bins]


def resolve_unique(best_feat, best_dist, has, n_feats: int):
    """Each feature keeps only the lowest-distance claiming point; ties go
    to the lowest point index."""
    P = best_feat.shape[0]
    dev = best_feat.device
    park = torch.full_like(best_feat, n_feats)      # invalid -> slot n_feats
    feat_safe = torch.where(has, best_feat, park)
    seg_min = torch.full((n_feats + 1,), BIG, dtype=best_dist.dtype, device=dev)
    seg_min = seg_min.scatter_reduce(0, feat_safe, best_dist, "amin",
                                     include_self=True)
    is_winner = has & (best_dist == seg_min[feat_safe])
    pid = torch.arange(P, dtype=torch.int64, device=dev)
    seg_pid = torch.full((n_feats + 1,), P, dtype=torch.int64, device=dev)
    seg_pid = seg_pid.scatter_reduce(0, torch.where(is_winner, feat_safe, park),
                                     pid, "amin", include_self=True)
    final = is_winner & (seg_pid[feat_safe] == pid)
    feat_idx = torch.where(final, best_feat, torch.full_like(best_feat, -1))
    point_of_feat = torch.full((n_feats + 1,), -1, dtype=torch.int64, device=dev)
    point_of_feat = point_of_feat.scatter_reduce(
        0, torch.where(final, feat_safe, park), pid, "amax",
        include_self=True)[:n_feats]
    return feat_idx, point_of_feat, torch.sum(final)


def match_resolve_ref(best, dist, has, n_feats: int, ang_ref=None,
                      ang_tab=None):
    """Plain version: the rotation filter (where ang_ref is given: row
    angles [P] against ang_tab[best], ang_tab [n_feats]) and the
    uniqueness resolution -> (feat_idx [P] int64, point_of_feat
    [n_feats] int64, n int64)."""
    if ang_ref is not None:
        has = rotation_consistency(ang_ref, ang_tab[best], has)
    return resolve_unique(best, dist, has, n_feats)


# ------------------------------------------------------------------ kernel

class _Strided(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("s", ctypes.c_int64)]


class _RowsParams(ctypes.Structure):
    """csrc/match.cu RowsParams."""
    _fields_ = ([(n, ctypes.c_int64) for n in ("mode", "n_rows", "n_cols")]
                + [(n, ctypes.c_void_p) for n in ("row_desc", "col_desc")]
                + [(n, _Strided) for n in (
                    "row_x", "row_y", "row_ur", "row_r", "row_key", "row_ok",
                    "col_x", "col_y", "col_w", "col_key", "col_ok",
                    "col_taken")]
                + [(n, ctypes.c_int64) for n in ("band_lo", "band_hi",
                                                 "band_open", "th")]
                + [(n, ctypes.c_void_p) for n in ("idx", "dist", "has",
                                                  "scratch")]
                + [(n, ctypes.c_float) for n in ("ratio", "max_d")])


class _ResolveParams(ctypes.Structure):
    """csrc/match.cu ResolveParams."""
    _fields_ = ([(n, ctypes.c_int64) for n in ("n_rows", "n_cols",
                                               "rotation")]
                + [(n, ctypes.c_void_p) for n in ("best", "dist", "has")]
                + [(n, _Strided) for n in ("ang_ref", "ang_tab")]
                + [("out", ctypes.c_void_p), ("bin_scale", ctypes.c_float)])


_SOURCE = cuda_build.CSRC / "match.cu"
_SIGNATURES = {
    "airdos_match_rows": [ctypes.POINTER(_RowsParams), ctypes.c_void_p],
    "airdos_match_resolve": [ctypes.POINTER(_ResolveParams),
                             ctypes.c_void_p],
}
_MAX_INDEX = 1 << INDEX_BITS
_SMEM_LIMIT = 232448             # bytes of shared memory a block can use
_lib = None                      # the loaded library, once built

_rows_counter = cuda_build.LaunchCounter()
_resolve_counter = cuda_build.LaunchCounter()


def launches() -> int:
    """match_rows launches since the last reset_launches()."""
    return _rows_counter.total


def resolve_launches() -> int:
    """match_resolve launches since the last reset_launches()."""
    return _resolve_counter.total


def launch_tally() -> dict:
    """{(kernel, thread name, stream priority): launches} since the last
    reset_launches(), kernel "match_rows" or "match_resolve"."""
    return {(name,) + key: n
            for name, counter in (("match_rows", _rows_counter),
                                  ("match_resolve", _resolve_counter))
            for key, n in counter.tally().items()}


def reset_launches() -> None:
    _rows_counter.reset()
    _resolve_counter.reset()


def build():
    """Compile csrc/match.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def _library():
    global _lib
    if _lib is None:
        _lib = cuda_build.library(_SOURCE, _SIGNATURES)
    return _lib


def _vec(name: str, x, n: int, dtype, device) -> _Strided:
    """A 1-D [n] tensor of `dtype` on `device` as (pointer, stride); None
    as a null pointer."""
    if x is None:
        return _Strided(None, 0)
    if x.device != device or x.dtype != dtype or x.dim() != 1 \
            or x.shape[0] != n:
        raise ValueError(f"{name} must be a {dtype} [{n}] tensor on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return _Strided(x.data_ptr(), x.stride(0))


def _desc(name: str, x: torch.Tensor, device) -> torch.Tensor:
    """[n, 8] int32 descriptors, contiguous and starting on 16 bytes (the
    kernel reads a descriptor as two 16-byte vectors)."""
    if x.device != device or x.dtype != torch.int32 or x.dim() != 2 \
            or x.shape[1] != 8:
        raise ValueError(f"{name} must be an int32 [n, 8] tensor on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def match_rows_cuda(mode: int, rows: MatchRows, cols: MatchCols, th: int,
                    ratio: float = 0.0, band=(None, None),
                    max_d: float = 0.0) -> RowMatches:
    """Launch match_rows on the current stream (one launch; stereo mode
    also zeroes its column scratch with a memset)."""
    dev = rows.desc.device
    if not rows.desc.is_cuda:
        raise ValueError(f"rows.desc must be a CUDA tensor, got {dev}")
    if mode not in (MOTION, LOCAL, STEREO, BOW):
        raise ValueError(f"unknown mode {mode}")
    rd = _desc("rows.desc", rows.desc, dev)
    cd = _desc("cols.desc", cols.desc, dev)
    P, N = rd.shape[0], cd.shape[0]
    if N == 0 or P >= _MAX_INDEX or N >= _MAX_INDEX \
            or 21 * N > _SMEM_LIMIT:
        raise ValueError(f"{P} rows x {N} columns: the kernel takes 1 to "
                         f"{_SMEM_LIMIT // 21} columns and < {_MAX_INDEX} "
                         f"rows")
    geo, proj = mode != BOW, mode in (MOTION, LOCAL)
    missing = [name for name, x, needed in (
        ("rows.x", rows.x, geo), ("rows.y", rows.y, geo),
        ("rows.ur", rows.ur, proj), ("rows.radius", rows.radius, proj),
        ("cols.x", cols.x, geo), ("cols.y", cols.y, geo),
        ("cols.w", cols.w, geo)) if needed and x is None]
    if missing:
        raise ValueError(f"mode {mode} needs {', '.join(missing)}")
    f32, b8 = torch.float32, torch.bool
    q = _RowsParams()
    q.mode, q.n_rows, q.n_cols = mode, P, N
    q.row_desc, q.col_desc = rd.data_ptr(), cd.data_ptr()
    q.row_key = _vec("rows.key", rows.key, P, torch.int64, dev)
    q.col_key = _vec("cols.key", cols.key, N, torch.int64, dev)
    q.row_ok = _vec("rows.ok", rows.ok, P, b8, dev)
    q.col_ok = _vec("cols.ok", cols.ok, N, b8, dev)
    q.col_taken = _vec("cols.taken", cols.taken, N, b8, dev)
    if geo:
        q.row_x = _vec("rows.x", rows.x, P, f32, dev)
        q.row_y = _vec("rows.y", rows.y, P, f32, dev)
        q.col_x = _vec("cols.x", cols.x, N, f32, dev)
        q.col_y = _vec("cols.y", cols.y, N, f32, dev)
        q.col_w = _vec("cols.w", cols.w, N, f32, dev)
    if proj:
        q.row_ur = _vec("rows.ur", rows.ur, P, f32, dev)
        q.row_r = _vec("rows.radius", rows.radius, P, f32, dev)
    lo, hi = band
    q.band_lo, q.band_hi = lo or 0, hi or 0
    q.band_open = (lo is None) | (hi is None) << 1
    q.th = int(th)
    q.ratio, q.max_d = float(np.float32(ratio)), float(np.float32(max_d))
    # one allocation: idx int64 [2P (+ N)], dist int32 [2P], the stereo
    # column scratch int32 [N + 1], has bool [P]
    n_idx = 2 * P + (N if mode == STEREO else 0)
    n_scratch = N + 1 if mode == STEREO else 0
    o_dist = 8 * n_idx
    o_scratch = o_dist + 8 * P
    o_has = o_scratch + 4 * n_scratch
    buf = torch.empty(o_has + P, dtype=torch.uint8, device=dev)
    idx = buf[:o_dist].view(torch.int64)
    dist = buf[o_dist:o_scratch].view(torch.int32)
    has = buf[o_has:].view(torch.bool)
    q.idx, q.dist, q.has = idx.data_ptr(), dist.data_ptr(), has.data_ptr()
    q.scratch = buf[o_scratch:].data_ptr() if n_scratch else None
    if P:
        with cuda_build.on_device(dev):
            err = _library().airdos_match_rows(
                ctypes.byref(q), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"match_rows kernel launch failed: "
                               f"cudaError {err}")
        _rows_counter.count(cuda_build.stream_priority(dev))
    elif mode == STEREO:
        idx.zero_()
    return RowMatches(best=idx[:P], dist=dist[:P], second=idx[P:2 * P],
                      second_dist=dist[P:], has=has, col_best=idx[2 * P:])


def match_resolve_cuda(best, dist, has, n_feats: int, ang_ref=None,
                       ang_tab=None):
    """Launch match_resolve (one block) on the current stream."""
    dev = best.device
    if not best.is_cuda:
        raise ValueError(f"best must be a CUDA tensor, got {dev}")
    P = best.shape[0]
    if 8 * n_feats > _SMEM_LIMIT or P >= 2 ** 32:
        raise ValueError(f"{n_feats} features, {P} rows exceed the kernel's "
                         f"shared memory or keys")
    best = best.contiguous()
    dist = dist.contiguous()
    has = has.contiguous()
    q = _ResolveParams()
    q.n_rows, q.n_cols = P, n_feats
    q.rotation = ang_ref is not None
    q.best = _vec("best", best, P, torch.int64, dev).p
    q.dist = _vec("dist", dist, P, torch.int32, dev).p
    q.has = _vec("has", has, P, torch.bool, dev).p
    if ang_ref is not None:
        q.ang_ref = _vec("ang_ref", ang_ref, P, torch.float32, dev)
        q.ang_tab = _vec("ang_tab", ang_tab, n_feats, torch.float32, dev)
    q.bin_scale = float(np.float32(HISTO_BINS / 360.0))
    out = torch.empty(P + n_feats + 1, dtype=torch.int64, device=dev)
    q.out = out.data_ptr()
    with cuda_build.on_device(dev):
        err = _library().airdos_match_resolve(
            ctypes.byref(q), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"match_resolve kernel launch failed: "
                           f"cudaError {err}")
    _resolve_counter.count(cuda_build.stream_priority(dev))
    return out[:P], out[P:P + n_feats], out[P + n_feats]


def match_rows(mode: int, rows: MatchRows, cols: MatchCols, th: int,
               ratio: float = 0.0, band=(None, None),
               max_d: float = 0.0) -> RowMatches:
    """Gate, best and second column, threshold and ratio test (and in
    stereo mode the mutual check) of a matcher: CUDA tensors go to the
    kernel, CPU tensors to the plain version."""
    if rows.desc.is_cuda:
        return match_rows_cuda(mode, rows, cols, th, ratio, band, max_d)
    return match_rows_ref(mode, rows, cols, th, ratio, band, max_d)


def match_resolve(best, dist, has, n_feats: int, ang_ref=None, ang_tab=None):
    """Rotation filter (where ang_ref is given) and uniqueness resolution
    -> (feat_idx [P] int64, point_of_feat [n_feats] int64, n int64): CUDA
    tensors go to the kernel, CPU tensors to the plain version."""
    if best.is_cuda:
        return match_resolve_cuda(best, dist, has, n_feats, ang_ref, ang_tab)
    return match_resolve_ref(best, dist, has, n_feats, ang_ref, ang_tab)
