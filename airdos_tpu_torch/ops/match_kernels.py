"""The matchers' gate, reductions and uniqueness: a CUDA kernel + plain
twins.

The stereo, motion-model, local-map and BoW matchers
(matching/stereo.py, matching/projection.py, matching/bow_match.py), the
loop's Sim3 match (matching/sim3_match.py, on motion mode), the mapping's
duplicate fusion (matching/fuse.py) and triangulation's epipolar search
(matching/epipolar.py) each compute, over rows
(points or left keypoints) and columns (features or right keypoints), the
Hamming distance of every pair that passes a gate, each row's best (and,
but in fusion, second-best) column, a threshold and ratio test, then (the
projection and BoW matchers) a rotation-histogram filter and the
uniqueness resolution.  airdos_tpu reaches the Pallas Hamming kernel
there (airdos_tpu/ops/pallas_kernels.py:36; fusion and triangulation
under jax.vmap over their target keyframes) and leaves the rest to XLA;
here one kernel of ``csrc/match.cu`` does it all, one launch a matcher
call:

- ``match_rows`` in six modes (``MOTION``, ``LOCAL``, ``STEREO``,
  ``BOW``, ``FUSE``, ``EPIPOLAR``): gate, distances, best, second, the
  ratio test and, in stereo mode, the column argmin and the mutual check;
  where asked (``resolve=True``: motion, local, bow) the rotation
  histogram's three largest bins and the uniqueness resolution in the
  same launch; in fuse and epipolar mode a batch of targets (rows [B, P]
  but the shared descriptors, columns [B, N]) and feat_idx.  No [P, N]
  or [B, P, N] matrix is written.

The wrapper, on CUDA tensors, launches the sm_90a kernel on the calling
thread's current stream (built with nvcc at first use into
``airdos_tpu_torch/_build/``, bound through ctypes) or raises, and counts
the launch, by thread and stream priority too; on CPU tensors it runs
the plain version (``match_rows_ref``, which calls ``match_resolve_ref``
for the resolve): the eager compositions around the Hamming matrix the
matchers had, so the CPU results are theirs bit for bit.  The kernel's
outputs equal the plain version's bit for bit (the CUDA source says
why).
"""
from __future__ import annotations

import ctypes
import struct
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from airdos_tpu_torch.ops import cuda_build
from airdos_tpu_torch.ops.hamming_kernels import (hamming_matrix_batched_ref,
                                                  hamming_matrix_ref)

MOTION, LOCAL, STEREO, BOW, FUSE, EPIPOLAR = 0, 1, 2, 3, 4, 5  # the modes
BATCHED = (FUSE, EPIPOLAR)                  # a batch of targets
BIG = 1 << 10                               # a pair outside the gate
HISTO_BINS = 30
INDEX_BITS = 21                             # rows and columns < 2^21
FAR_U = 1.5                                 # stereo: a second at another u
SECOND_CLAMP = 256                          # stereo: min(second, 256)
CHI2_STEREO, CHI2_MONO = 7.8, 5.99          # fuse: the chi-square bounds
EPI_CHI2 = 3.84                             # epipolar: the band's chi-square
EPI_MIN_NORM2 = 1e-12                       # epipolar: l0^2 + l1^2 floor

# the kernel's grid of cells a mode (x, y: ORB-SLAM's 64 x 48 over the
# columns' extent; bow: buckets of the key), and its blocks an SM
CELLS = {MOTION: (64, 48), LOCAL: (64, 48), STEREO: (64, 48),
         BOW: (256, 1), FUSE: (64, 48), EPIPOLAR: (64, 48)}
BLOCKS_PER_SM = 3


class MatchRows(NamedTuple):
    """The row side of a match (points, left keypoints or set 1); in fuse
    mode every field but desc is [B, P], one row a target; in epipolar
    mode desc, key and ok are the keyframe's [P], shared by the batch, and
    line is [B, P, 3]."""
    desc: torch.Tensor                      # [P, 8] int32
    key: torch.Tensor                       # [P] int64: octave or BoW node
    ok: torch.Tensor                        # [P] bool
    x: Optional[torch.Tensor] = None        # [P] float32 u (not bow)
    y: Optional[torch.Tensor] = None        # [P] float32 v (not bow)
    ur: Optional[torch.Tensor] = None       # [P] float32 (projection, fuse)
    radius: Optional[torch.Tensor] = None   # [P] float32 (projection, fuse)
    # epipolar: each row's line (l0, l1, l2) in each target's image
    line: Optional[torch.Tensor] = None     # [B, P, 3] float32


class MatchCols(NamedTuple):
    """The column side (features, right keypoints or set 2); in fuse and
    epipolar mode desc is [B, N, 8] and every other field [B, N]."""
    desc: torch.Tensor                      # [N, 8] int32
    key: torch.Tensor                       # [N] int64: octave or BoW node
    ok: torch.Tensor                        # [N] bool
    x: Optional[torch.Tensor] = None        # [N] float32 (not bow)
    y: Optional[torch.Tensor] = None        # [N] float32 (not bow)
    # projection: the feature's right u (gated where > 0); stereo: the
    # row band 2 * scale[octave]; fuse: the right u (chi-square in three
    # coordinates where >= 0); epipolar: sigma2[octave]
    w: Optional[torch.Tensor] = None
    taken: Optional[torch.Tensor] = None    # [N] bool (projection)


class RowMatches(NamedTuple):
    best: torch.Tensor          # [P] int64 argmin column (0 where none)
    dist: torch.Tensor          # [P] int32 its distance (BIG where none)
    second: torch.Tensor        # [P] int64 the mode's second column
    second_dist: torch.Tensor   # [P] int32
    has: torch.Tensor           # [P] bool threshold and ratio (and mutual)
    col_best: torch.Tensor      # [N] int64 column argmin (stereo; else [0])
    # the resolve: the winning column or -1; fuse, epipolar: best where
    # has, else -1 ([B, P]); else [0]
    feat_idx: torch.Tensor
    point_of_feat: torch.Tensor  # [N] int64 the resolve's winning row (-1)
    n: torch.Tensor             # int64 the resolve's matches (else [0])


def gate(mode: int, rows: MatchRows, cols: MatchCols, band,
          max_d: float, sigma2=None) -> torch.Tensor:
    """[P, N] bool (fuse, epipolar: [B, P, N]): the matchers' gating, as
    they computed it."""
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
    if mode == FUSE:
        return _fuse_gate(rows, cols, sigma2)
    if mode == EPIPOLAR:
        return _epipolar_gate(rows, cols)
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


def _fuse_gate(rows: MatchRows, cols: MatchCols, sigma2) -> torch.Tensor:
    """[B, P, N]: fusion's window at the predicted level's radius, octave
    band [pred - 1, pred + 1] and reprojection chi-square (5.99 mono /
    7.8 with a right u), as matching/fuse.py composed it."""
    radius = rows.radius[..., None]                              # [B, P, 1]
    du = cols.x[:, None, :] - rows.x[..., None]                  # [B, P, N]
    dv = cols.y[:, None, :] - rows.y[..., None]
    win_ok = (torch.abs(du) < radius) & (torch.abs(dv) < radius)
    lf = cols.key[:, None, :]
    oct_ok = (lf >= rows.key[..., None] - 1) & (lf <= rows.key[..., None] + 1)
    s2 = sigma2[cols.key][:, None, :]
    e2 = du * du + dv * dv
    der = cols.w[:, None, :] - rows.ur[..., None]
    has_r = (cols.w >= 0)[:, None, :]
    chi = torch.where(has_r, (e2 + der * der) / s2, e2 / s2)
    chi_ok = torch.where(has_r, chi <= CHI2_STEREO, chi <= CHI2_MONO)
    return win_ok & oct_ok & chi_ok & rows.ok[..., None] & \
        cols.ok[:, None, :]


def _epipolar_gate(rows: MatchRows, cols: MatchCols) -> torch.Tensor:
    """[B, P, N]: the squared distance of each column to each row's line
    under 3.84 sigma2 of the column's octave, as matching/epipolar.py
    composed it (the epipole test is in cols.ok)."""
    l0, l1, l2 = rows.line[..., 0:1], rows.line[..., 1:2], \
        rows.line[..., 2:3]                                      # [B, P, 1]
    dist_num = l0 * cols.x[:, None, :] + l1 * cols.y[:, None, :] + l2
    dist2 = dist_num * dist_num / torch.clamp(l0 ** 2 + l1 ** 2,
                                              min=EPI_MIN_NORM2)
    return (dist2 < EPI_CHI2 * cols.w[:, None, :]) & \
        rows.ok[None, :, None] & cols.ok[:, None, :]


def reduce_gated(mode: int, D: torch.Tensor, col_key: torch.Tensor,
                 col_x, th: int, ratio: float) -> RowMatches:
    """The plain version's reductions of a gated distance matrix D [P, N]
    (int32, BIG outside the gate): best, the mode's second, the threshold
    and ratio test and, in stereo mode, the column argmin and the mutual
    check; in fuse and epipolar mode D is [B, P, N] and the reductions
    are best, its distance, has and feat_idx.  col_key: the columns'
    octaves (local mode's level test); col_x: their u (stereo's far-u
    second)."""
    if mode in BATCHED:
        best = torch.argmin(D, dim=2)
        dist = torch.gather(D, 2, best[..., None])[..., 0]
        none = best.new_zeros(0)
        return RowMatches(
            best=best, dist=dist, second=none, second_dist=none.int(),
            has=dist <= th, col_best=none,
            feat_idx=torch.where(dist <= th, best, torch.full_like(best, -1)),
            point_of_feat=none, n=none)
    P = D.shape[0]
    best = torch.argmin(D, dim=1)
    dist = torch.gather(D, 1, best[:, None])[:, 0]
    none = best.new_zeros(0)
    col_best = none
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
                      second_dist=second_dist, has=has, col_best=col_best,
                      feat_idx=none, point_of_feat=none, n=none)


def match_rows_ref(mode: int, rows: MatchRows, cols: MatchCols, th: int,
                   ratio: float = 0.0, band=(None, None),
                   max_d: float = 0.0, resolve: bool = False, angles=None,
                   sigma2=None) -> RowMatches:
    """Plain version: the gated [P, N] (fuse, epipolar: [B, P, N])
    distance matrix and its reductions, the matchers' eager composition.
    th: the largest distance accepted; band: (lo, hi) octave offsets
    from the row's key (None: open), for the projection modes; max_d:
    stereo's largest disparity; resolve: then match_resolve_ref over the
    columns, with the rotation filter where angles = (row angles [P],
    column angles [N]); sigma2: fuse's [levels] float32 sigma^2 table."""
    ok = gate(mode, rows, cols, band, max_d, sigma2)
    D = hamming_matrix_batched_ref(rows.desc[None], cols.desc) \
        if mode in BATCHED else hamming_matrix_ref(rows.desc, cols.desc)
    D = torch.where(ok, D, torch.full_like(D, BIG))
    rm = reduce_gated(mode, D, cols.key, cols.x, th, ratio)
    if not resolve or mode in BATCHED:
        return rm
    feat_idx, point_of_feat, n = match_resolve_ref(
        rm.best, rm.dist, rm.has, cols.desc.shape[0],
        *(angles if angles is not None else (None, None)))
    return rm._replace(feat_idx=feat_idx, point_of_feat=point_of_feat, n=n)


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
    """Plain version of the resolve: the rotation filter (where ang_ref is
    given: row angles [P] against ang_tab[best], ang_tab [n_feats]) and
    the uniqueness resolution -> (feat_idx [P] int64, point_of_feat
    [n_feats] int64, n int64)."""
    if ang_ref is not None:
        has = rotation_consistency(ang_ref, ang_tab[best], has)
    return resolve_unique(best, dist, has, n_feats)


# ------------------------------------------------------------------ kernel

# csrc/match.cu RowsParams: 63 int64 words (counts, pointers, the strided
# vectors' (pointer, stride, batch stride)) and 4 float32
_PARAMS = struct.Struct("<63q4f")
_SOURCE = cuda_build.CSRC / "match.cu"
_SIGNATURES = {
    "airdos_match_rows": [ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_void_p],
    "airdos_match_smem": [ctypes.c_longlong] * 2,
    "airdos_match_scratch": [ctypes.c_longlong] * 4,
}
_MAX_INDEX = 1 << INDEX_BITS
_SMEM_LIMIT = 200 * 1024        # the dynamic shared memory the kernel may ask
_BIN_SCALE = float(np.float32(HISTO_BINS / 360.0))
_NONE = (0, 0, 0)               # a null vector
_lib = None                     # the loaded library, once built
_local = threading.local()      # each thread's parameter block
_sizes = {}                     # (mode, P, N, cells, resolve) ->
#                                 (shared bytes, scratch words)
_sms = {}                       # device index -> SMs
_priority = {}                  # raw stream -> its priority
_empty = {}                     # device -> empty int64 and int32 outputs

_rows_counter = cuda_build.LaunchCounter()
_resolve_counter = cuda_build.LaunchCounter()
_fuse_counter = cuda_build.LaunchCounter()
_epipolar_counter = cuda_build.LaunchCounter()


def launches() -> int:
    """match_rows launches since the last reset_launches()."""
    return _rows_counter.total


def resolve_launches() -> int:
    """match_rows launches that ran the resolve (the rotation filter and
    the uniqueness, which match_resolve launched before the resolve was
    folded into match_rows) since the last reset_launches()."""
    return _resolve_counter.total


def fuse_launches() -> int:
    """match_rows launches in fuse mode since the last reset_launches()."""
    return _fuse_counter.total


def epipolar_launches() -> int:
    """match_rows launches in epipolar mode since the last
    reset_launches()."""
    return _epipolar_counter.total


def launch_tally() -> dict:
    """{(kernel, thread name, stream priority): launches} since the last
    reset_launches(), kernel "match_rows" (every launch), "match_resolve"
    (those that ran the resolve), "match_fuse" (fuse mode) or
    "match_epipolar" (epipolar mode)."""
    return {(name,) + key: n
            for name, counter in (("match_rows", _rows_counter),
                                  ("match_resolve", _resolve_counter),
                                  ("match_fuse", _fuse_counter),
                                  ("match_epipolar", _epipolar_counter))
            for key, n in counter.tally().items()}


def reset_launches() -> None:
    _rows_counter.reset()
    _resolve_counter.reset()
    _fuse_counter.reset()
    _epipolar_counter.reset()


def build():
    """Compile csrc/match.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def _library():
    global _lib
    if _lib is None:
        _lib = cuda_build.library(_SOURCE, _SIGNATURES)
    return _lib


def _stream(dev: torch.device):
    """The raw current stream of `dev` and its priority (cached: torch's
    streams come from pools that live as long as the process)."""
    raw = torch._C._cuda_getCurrentRawStream(dev.index)
    prio = _priority.get(raw)
    if prio is None:
        prio = _priority[raw] = cuda_build.stream_priority(dev)
    return raw, prio


def _v(x) -> tuple:
    """A vector as the kernel's (pointer, stride, batch stride)."""
    if x is None:
        return _NONE
    s = x.stride()
    return (x.data_ptr(), s[1], s[0]) if len(s) == 2 else \
        (x.data_ptr(), s[0], 0)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Descriptors contiguous and starting on 16 bytes (the kernel reads a
    descriptor as two 16-byte vectors): x itself, else a copy."""
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _check(mode, rows, cols, resolve, angles, sigma2):
    """Raise unless the inputs are what the kernel reads: every tensor on
    the descriptors' CUDA device, of its dtype and shape."""
    dev = rows.desc.device
    if not rows.desc.is_cuda:
        raise ValueError(f"rows.desc must be a CUDA tensor, got {dev}")
    if mode not in (MOTION, LOCAL, STEREO, BOW, FUSE, EPIPOLAR):
        raise ValueError(f"unknown mode {mode}")
    fuse, epi = mode == FUSE, mode == EPIPOLAR
    cdims = 3 if mode in BATCHED else 2
    for name, x, dims in (("rows.desc", rows.desc, 2),
                          ("cols.desc", cols.desc, cdims)):
        if x.device != dev or x.dtype != torch.int32 or x.dim() != dims \
                or x.shape[-1] != 8:
            raise ValueError(f"{name} must be an int32 [..., 8] tensor on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    P, N = rows.desc.shape[0], cols.desc.shape[-2]
    B = cols.desc.shape[0] if mode in BATCHED else None
    if N == 0 or P >= _MAX_INDEX or N >= _MAX_INDEX:
        raise ValueError(f"{P} rows x {N} columns: the kernel takes 1 to "
                         f"{_MAX_INDEX - 1} columns and < {_MAX_INDEX} rows")
    geo, proj = mode != BOW, mode in (MOTION, LOCAL, FUSE)
    missing = [name for name, x, needed in (
        ("rows.x", rows.x, geo and not epi),
        ("rows.y", rows.y, geo and not epi),
        ("rows.ur", rows.ur, proj), ("rows.radius", rows.radius, proj),
        ("cols.x", cols.x, geo), ("cols.y", cols.y, geo),
        ("cols.w", cols.w, geo), ("sigma2", sigma2, fuse),
        ("rows.line", rows.line, epi)) if needed and x is None]
    if missing:
        raise ValueError(f"mode {mode} needs {', '.join(missing)}")
    if resolve and mode not in (MOTION, LOCAL, BOW):
        raise ValueError(f"mode {mode} has no resolve")
    f32, b8, i64 = torch.float32, torch.bool, torch.int64
    if epi and (rows.line.device != dev or rows.line.dtype != f32
                or tuple(rows.line.shape) != (B, P, 3)
                or not rows.line.is_contiguous()):
        raise ValueError(f"rows.line must be a contiguous float32 "
                         f"[{B}, {P}, 3] tensor on {dev}, got "
                         f"{rows.line.dtype} {tuple(rows.line.shape)} on "
                         f"{rows.line.device}")
    # fuse: every row vector a target's; epipolar: the rows' key and ok
    # shared by the batch (their line is checked above)
    rl, cl = (B,) if fuse else (), (B,) if mode in BATCHED else ()
    row_vecs = () if epi else (
        ("rows.x", rows.x, f32, rl, P), ("rows.y", rows.y, f32, rl, P),
        ("rows.ur", rows.ur, f32, rl, P),
        ("rows.radius", rows.radius, f32, rl, P))
    for name, x, dtype, lead, n in (
            ("rows.key", rows.key, i64, rl, P),
            ("rows.ok", rows.ok, b8, rl, P), *row_vecs,
            ("cols.key", cols.key, i64, cl, N),
            ("cols.ok", cols.ok, b8, cl, N),
            ("cols.x", cols.x, f32, cl, N), ("cols.y", cols.y, f32, cl, N),
            ("cols.w", cols.w, f32, cl, N),
            ("cols.taken", cols.taken, b8, cl, N)):
        if x is not None and (x.device != dev or x.dtype != dtype
                              or tuple(x.shape) != lead + (n,)):
            raise ValueError(f"{name} must be a {dtype} {list(lead + (n,))} "
                             f"tensor on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    for name, x, n in (("angles[0]", None if angles is None else angles[0], P),
                       ("angles[1]", None if angles is None else angles[1], N),
                       ("sigma2", sigma2, None)):
        if x is not None and (x.device != dev or x.dtype != f32
                              or x.dim() != 1
                              or (n is not None and x.shape[0] != n)
                              or x.shape[0] == 0):
            raise ValueError(f"{name} must be a float32 [{n or 'levels'}] "
                             f"tensor on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def match_rows_cuda(mode: int, rows: MatchRows, cols: MatchCols, th: int,
                    ratio: float = 0.0, band=(None, None),
                    max_d: float = 0.0, resolve: bool = False, angles=None,
                    sigma2=None, check: bool = True) -> RowMatches:
    """Launch match_rows on the current stream: one launch (stereo and
    the resolve also zero the last block's counter with a memset).
    check=False skips the input checks, for callers whose inputs are
    built as the kernel reads them."""
    if check:
        _check(mode, rows, cols, resolve, angles, sigma2)
    rd, cd = _aligned(rows.desc), _aligned(cols.desc)
    dev = rd.device
    fuse, stereo, epi = mode == FUSE, mode == STEREO, mode == EPIPOLAR
    batched = fuse or epi
    resolve = bool(resolve)
    P, N = rows.desc.shape[0], cols.desc.shape[-2]
    B = cols.desc.shape[0] if batched else 1
    gx, gy = CELLS[mode]
    key = (mode, P, N, gx * gy, resolve)
    sizes = _sizes.get(key)
    if sizes is None:
        lib = _library()
        sizes = _sizes[key] = (lib.airdos_match_smem(N, gx * gy),
                               lib.airdos_match_scratch(mode, P, N, resolve))
    smem, n_scr = sizes
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{N} columns need {smem} bytes of shared memory, "
                         f"over {_SMEM_LIMIT}")
    # one allocation: int64 best, second (batched: feat_idx) [BP], stereo's
    # column argmin [N], the resolve's feat_idx [P], point_of_feat [N], n;
    # int32 dist [BP], second [P]; the uint32 scratch; bool has [BP]
    BP = B * P
    n64 = 2 * BP + (N if stereo else 0) + (P + N + 1 if resolve else 0)
    n32 = BP + (0 if batched else P)
    o_dist = 8 * n64
    o_scr = o_dist + 4 * n32
    o_has = o_scr + 4 * n_scr
    buf = torch.empty(o_has + BP, dtype=torch.uint8, device=dev)
    base = buf.data_ptr()
    sms = _sms.get(dev.index)
    if sms is None:
        sms = _sms[dev.index] = \
            torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(-(-P // 8), -(-sms * BLOCKS_PER_SM // B)))
    lo, hi = band
    ang_ref, ang_tab = angles if angles is not None else (None, None)
    words = _local.__dict__.get("params")
    if words is None:
        block = ctypes.create_string_buffer(_PARAMS.size)
        words = _local.params = (block, ctypes.addressof(block))
    if epi:
        # the line's three coefficients as the rows' x, y and ur vectors
        ln = rows.line.data_ptr()
        row_geo = (ln, 3, 3 * P, ln + 4, 3, 3 * P, ln + 8, 3, 3 * P,
                   *_NONE)
    else:
        row_geo = (*_v(rows.x), *_v(rows.y), *_v(rows.ur),
                   *_v(rows.radius))
    _PARAMS.pack_into(
        words[0], 0, mode, P, N, B,
        rd.data_ptr(), cd.data_ptr(), N if batched else 0, *row_geo,
        *_v(rows.key), *_v(rows.ok),
        *_v(cols.x), *_v(cols.y), *_v(cols.w), *_v(cols.key),
        *_v(cols.ok), *_v(cols.taken),
        *_v(ang_ref), *_v(ang_tab),
        sigma2.data_ptr() if fuse else 0,
        sigma2.shape[0] if fuse else 0,
        lo or 0, hi or 0, (lo is None) | (hi is None) << 1, int(th),
        resolve, gx, gy, blocks,
        base, base + o_dist, base + o_has, base + o_scr if n_scr else 0,
        ratio, max_d, _BIN_SCALE, 0.0)
    b64, b32, _, b8 = buf.split((o_dist, o_scr - o_dist, o_has - o_scr, BP))
    idx, dist, has = b64.view(torch.int64), b32.view(torch.int32), \
        b8.view(torch.bool)
    if P:
        raw, prio = _stream(dev)
        with cuda_build.on_device(dev):
            err = _library().airdos_match_rows(words[1], smem, raw)
        if err != 0:
            raise RuntimeError(f"match_rows kernel launch failed: "
                               f"cudaError {err}")
        _rows_counter.count(prio)
        if resolve:
            _resolve_counter.count(prio)
        if fuse:
            _fuse_counter.count(prio)
        if epi:
            _epipolar_counter.count(prio)
    elif stereo or resolve:
        idx.zero_()
        if resolve:
            idx[:N] = -1                 # point_of_feat (P = 0)
    none = _empty.get(dev)
    if none is None:
        none = _empty[dev] = (idx.new_empty(0), dist.new_empty(0))
    if batched:
        best, feat_idx = idx.view(2, B, P)
        return RowMatches(best=best, dist=dist.view(B, P), second=none[0],
                          second_dist=none[1], has=has.view(B, P),
                          col_best=none[0], feat_idx=feat_idx,
                          point_of_feat=none[0], n=none[0])
    best, second, *rest = idx.split(
        (P, P) + ((N,) if stereo else ()) + ((P, N, 1) if resolve else ()))
    d1, d2 = dist.split(P)
    if resolve:
        feat_idx, point_of_feat, n = rest
        n = n.view(())
    else:
        feat_idx = point_of_feat = n = none[0]
    return RowMatches(best=best, dist=d1, second=second, second_dist=d2,
                      has=has, col_best=rest[0] if stereo else none[0],
                      feat_idx=feat_idx, point_of_feat=point_of_feat, n=n)


def match_rows(mode: int, rows: MatchRows, cols: MatchCols, th: int,
               ratio: float = 0.0, band=(None, None), max_d: float = 0.0,
               resolve: bool = False, angles=None, sigma2=None,
               check: bool = True) -> RowMatches:
    """Gate, best and second column, threshold and ratio test (and in
    stereo mode the mutual check; with resolve the rotation filter and
    uniqueness; in fuse and epipolar mode a batch of targets) of a
    matcher: CUDA
    tensors go to the kernel, CPU tensors to the plain version."""
    if rows.desc.is_cuda:
        return match_rows_cuda(mode, rows, cols, th, ratio, band, max_d,
                               resolve, angles, sigma2, check)
    return match_rows_ref(mode, rows, cols, th, ratio, band, max_d,
                          resolve, angles, sigma2)
