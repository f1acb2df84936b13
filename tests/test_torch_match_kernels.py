"""csrc/match.cu's plain versions and reduction rules, on the CPU.

- The tracking matchers, which on CPU tensors compose
  ops/match_kernels.py's plain versions (match_rows_ref, match_resolve_ref)
  as they compose the kernels on the card, against airdos_tpu's
  stereo_match, match_last_frame, match_local_points and match_by_bow on
  the same seeded inputs (ORB features of two rendered frames of the small
  camera's world, 600 features, 4 levels): every integer output exact.
- A numpy emulation of the kernels' reductions (lanes striding over the
  columns with their two smallest packed keys, the warp minimum, stereo's
  far-u second pass, the column minima as complemented atomicMax in a
  random order and the last block's mutual check; the resolve kernel's
  histogram top 3 and its 64-bit key atomicMin in a random order) equal
  to the plain versions' torch.argmin / amin / scatter reductions, with
  all-BIG rows and columns, ties, far-u ties and ragged shapes.
- The float32 roundings the kernels repeat: ratio * second and the
  rotation bin's scale, as torch rounds a Python scalar.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airdos_tpu.matching.projection as jproj
import airdos_tpu_torch.matching.projection as tproj
import airdos_tpu_torch.ops.match_kernels as mk
from airdos_tpu.matching.bow_match import match_by_bow as jax_bow
from airdos_tpu_torch.matching.bow_match import match_by_bow
from test_torch_matching import (N_LEVELS, SCALES, _last_frame_points,  # noqa: F401
                                 _run_stereo, _t, scene)
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
import torch_match_cases as tcases

LANES = 32
NONE = mk.BIG << mk.INDEX_BITS          # the (BIG, index 0) key
MASK = (1 << mk.INDEX_BITS) - 1


# ------------------------------------------ the matchers against airdos_tpu

@pytest.mark.parametrize("frame", [0, 1])
def test_stereo_match_integers_equal_jax(scene, frame):
    cam, frames = scene
    inp = frames[frame]
    got = _run_stereo(inp, cam, "torch")
    ref = inp["stereo_jax"]
    assert (ref["best_right"] >= 0).sum() > 100
    np.testing.assert_array_equal(got["best_right"], ref["best_right"])


def _common(cam):
    return (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.width, cam.height)


@pytest.mark.parametrize("rule", ["within one", "forward", "backward"])
def test_match_last_frame_exactly_jax(scene, rule):
    cam, (a, b) = scene
    xw, valid = _last_frame_points(a, cam)
    u_right = b["stereo_jax"]["u_right"]
    taken = np.zeros(len(b["xy_l"]), bool)
    taken[::11] = True
    fwd, bwd = rule == "forward", rule == "backward"
    ref = jproj.match_last_frame(
        jnp.asarray(xw), jnp.asarray(a["desc_l"]), jnp.asarray(a["oct_l"]),
        jnp.asarray(a["ang_l"]), jnp.asarray(valid),
        jnp.asarray(b["Rcw"]), jnp.asarray(b["tcw"]), jnp.asarray(b["xy_l"]),
        jnp.asarray(u_right), jnp.asarray(b["oct_l"]), jnp.asarray(b["ang_l"]),
        jnp.asarray(b["desc_l"]), jnp.asarray(b["valid_l"]),
        jnp.asarray(taken), *_common(cam), jnp.asarray(SCALES), 7.0, fwd, bwd)
    got = tproj.match_last_frame(
        _t(xw), _t(a["desc_l"].view(np.int32)), _t(a["oct_l"]).long(),
        _t(a["ang_l"]), _t(valid), _t(b["Rcw"]), _t(b["tcw"]), _t(b["xy_l"]),
        _t(u_right), _t(b["oct_l"]).long(), _t(b["ang_l"]),
        _t(b["desc_l"].view(np.int32)), _t(b["valid_l"]), _t(taken),
        *_common(cam), _t(SCALES), 7.0, fwd, bwd)
    assert int(ref.n_matches) > 20
    assert int(got.n_matches) == int(ref.n_matches)
    for name in ("feat_idx", "dist", "point_of_feat"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.mark.parametrize("th", [1.0, 3.0])
def test_match_local_points_exactly_jax(scene, th):
    cam, (a, b) = scene
    xw, valid = _last_frame_points(a, cam)
    d = xw - a["ow"][None, :]
    dist = np.linalg.norm(d, axis=1)
    normal = (d / np.maximum(dist[:, None], 1e-9)).astype(np.float32)
    maxd = (1.2 * dist * 1.2 ** a["oct_l"]).astype(np.float32)
    mind = (0.8 * dist * 1.2 ** a["oct_l"]
            / 1.2 ** (N_LEVELS - 1)).astype(np.float32)
    u_right = b["stereo_jax"]["u_right"]
    taken = np.zeros(len(b["xy_l"]), bool)
    taken[::7] = True
    log_scale = float(np.log(1.2))
    ref = jproj.match_local_points(
        jnp.asarray(xw), jnp.asarray(a["desc_l"]), jnp.asarray(valid),
        jnp.asarray(normal), jnp.asarray(maxd), jnp.asarray(mind),
        jnp.asarray(b["Rcw"]), jnp.asarray(b["tcw"]), jnp.asarray(b["ow"]),
        jnp.asarray(b["xy_l"]), jnp.asarray(u_right), jnp.asarray(b["oct_l"]),
        jnp.asarray(b["desc_l"]), jnp.asarray(b["valid_l"]),
        jnp.asarray(taken), *_common(cam), jnp.asarray(SCALES), log_scale,
        N_LEVELS, th)
    got = tproj.match_local_points(
        _t(xw), _t(a["desc_l"].view(np.int32)), _t(valid), _t(normal),
        _t(maxd), _t(mind), _t(b["Rcw"]), _t(b["tcw"]), _t(b["ow"]),
        _t(b["xy_l"]), _t(u_right), _t(b["oct_l"]).long(),
        _t(b["desc_l"].view(np.int32)), _t(b["valid_l"]), _t(taken),
        *_common(cam), _t(SCALES), log_scale, N_LEVELS, th)
    assert int(ref.n_matches) > 20
    assert int(got.n_matches) == int(ref.n_matches)
    for name in ("feat_idx", "dist", "point_of_feat"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


def _nodes(desc, valid, rng):
    """Vocabulary-like node ids: the top three bits of the first word (a
    3-D point's two views mostly agree), -1 on invalid and a few others."""
    nodes = ((desc[:, 0] >> 29) & 7).astype(np.int64)
    nodes[~valid | (rng.uniform(size=len(nodes)) < 0.05)] = -1
    return nodes


@pytest.mark.parametrize("check_rotation", [True, False])
@pytest.mark.parametrize("nn_ratio", [0.7, 0.75])
def test_match_by_bow_exactly_jax(scene, check_rotation, nn_ratio):
    cam, (a, b) = scene
    rng = np.random.default_rng(5)
    n1, n2 = _nodes(a["desc_l"], a["valid_l"], rng), \
        _nodes(b["desc_l"], b["valid_l"], rng)
    ref = jax_bow(jnp.asarray(a["desc_l"]), jnp.asarray(n1),
                  jnp.asarray(a["valid_l"]), jnp.asarray(a["ang_l"]),
                  jnp.asarray(b["desc_l"]), jnp.asarray(n2),
                  jnp.asarray(b["valid_l"]), jnp.asarray(b["ang_l"]),
                  nn_ratio=nn_ratio, check_rotation=check_rotation)
    got = match_by_bow(_t(a["desc_l"].view(np.int32)), _t(n1),
                       _t(a["valid_l"]), _t(a["ang_l"]),
                       _t(b["desc_l"].view(np.int32)), _t(n2),
                       _t(b["valid_l"]), _t(b["ang_l"]),
                       nn_ratio=nn_ratio, check_rotation=check_rotation)
    assert int(ref.n_matches) > 20
    assert int(got.n_matches) == int(ref.n_matches)
    np.testing.assert_array_equal(got.idx2.numpy(), np.asarray(ref.idx2))
    np.testing.assert_array_equal(got.idx1_of_2.numpy(),
                                  np.asarray(ref.idx1_of_2))


# ------------------------------------------ the loop's Sim3 match

def _sim3_directional(x_in_cam, valid_p, desc_p, maxd_p, feat_xy, feat_oct,
                      feat_desc, feat_valid, fx, fy, cx, cy, width, height,
                      scale_factors, log_scale, n_levels, th):
    """matching/sim3_match.py's _directional as it was before it ran on
    match_rows: the masked dense [P, N] Hamming matrix and its argmin."""
    from airdos_tpu_torch.ops.hamming_kernels import hamming_matrix
    z = x_in_cam[:, 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = fx * x_in_cam[:, 0] * iz + cx
    v = fy * x_in_cam[:, 1] * iz + cy
    in_img = (u >= 0) & (u < width) & (v >= 0) & (v < height) & (z > 0)
    dist = torch.linalg.norm(x_in_cam, dim=-1)
    ratio = maxd_p / torch.where(dist < 1e-9, torch.full_like(dist, 1e-9), dist)
    pred = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_scale)
    pred = torch.clamp(pred, 0, n_levels - 1).to(torch.int64)
    dist_ok = (dist >= 0.8 * torch.where(maxd_p > 0, maxd_p,
                                         torch.full_like(maxd_p, 1e9)) /
               scale_factors[n_levels - 1]) & (dist <= 1.2 * maxd_p)
    radius = th * scale_factors[pred]
    du = torch.abs(feat_xy[None, :, 0] - u[:, None])
    dv = torch.abs(feat_xy[None, :, 1] - v[:, None])
    win_ok = (du < radius[:, None]) & (dv < radius[:, None])
    lf = feat_oct[None, :]
    oct_ok = (lf >= pred[:, None] - 1) & (lf <= pred[:, None])
    ok = (win_ok & oct_ok & (valid_p & in_img & dist_ok)[:, None] &
          feat_valid[None, :])
    D = hamming_matrix(desc_p, feat_desc)
    D = torch.where(ok, D, torch.full_like(D, mk.BIG))
    best = torch.argmin(D, dim=1)
    bdist = torch.gather(D, 1, best[:, None])[:, 0]
    return best, bdist <= 100


def _sim3_inputs(case):
    """match_by_sim3's positional arguments: tests/test_sim3_match.py's
    two-camera geometry (64 points, the true Sim3 or one 3.6 m off, every
    descriptor shared by both keyframes, octave 0) or seeded random
    inputs (600 points a keyframe, 8 octaves, noisy projections, a
    quarter of the descriptors and a fifth of the octaves random,
    repeated words)."""
    fx = fy = 320.0
    cx, cy, w, h = 160.0, 120.0, 320, 240
    if case in ("test_sim3_match", "bad sim3"):
        rng = np.random.default_rng(0)
        N, L = 64, 4
        pts = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                        rng.uniform(5, 15, N)], axis=1).astype(np.float32)
    else:
        rng = np.random.default_rng(int(case[-1]))
        N, L = 600, 8
        pts = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N),
                        rng.uniform(3, 25, N)], axis=1).astype(np.float32)
    ang = 0.1
    R2 = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                   [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    t2 = np.array([0.5, 0.1, -0.3], np.float32)
    x1, x2 = pts, (R2 @ pts.T).T + t2
    R12, t12 = R2.T, -R2.T @ t2
    if case == "bad sim3":
        t12 = t12 + np.array([3.0, 2.0, 0.0], np.float32)

    def feats(xc):
        return np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                         fy * xc[:, 1] / xc[:, 2] + cy], 1).astype(np.float32)

    desc = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32)
    x2_in_c1 = ((x2 @ R12.T) + t12).astype(np.float32)
    x1_in_c2 = ((x1 - t12) @ R12).astype(np.float32)
    maxd1 = np.linalg.norm(x1_in_c2, axis=1).astype(np.float32)
    maxd2 = np.linalg.norm(x2_in_c1, axis=1).astype(np.float32)
    xy1, xy2 = feats(x1), feats(x2)
    oct1 = oct2 = np.zeros(N, np.int64)
    valid1 = valid2 = np.ones(N, bool)
    desc1 = desc2 = desc
    if N == 600:
        xy1 = (xy1 + rng.normal(0, 1.0, xy1.shape)).astype(np.float32)
        xy2 = (xy2 + rng.normal(0, 1.0, xy2.shape)).astype(np.float32)
        # a point's predicted level k + 1 from its max distance, its
        # features at k (a fifth at random levels)
        k = rng.integers(0, L - 2, N)
        oct1, oct2 = [np.where(rng.uniform(size=N) < 0.2,
                               rng.integers(0, L, N), k) for _ in range(2)]
        maxd1 = (maxd1 * 1.05 * 1.2 ** k).astype(np.float32)
        maxd2 = (maxd2 * 1.05 * 1.2 ** k).astype(np.float32)
        valid1, valid2 = rng.uniform(size=N) < 0.9, rng.uniform(size=N) < 0.9
        desc2 = np.where(rng.uniform(size=(N, 1)) < 0.25,
                         rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint64),
                         desc).astype(np.uint32)
        desc2[7::7] = desc2[:-7:7]
    t = torch.from_numpy
    d1, d2 = t(desc1.view(np.int32)), t(desc2.view(np.int32))
    scale_factors = t(np.asarray([1.2 ** i for i in range(L)], np.float32))
    return [t(x2_in_c1), t(valid2), d2, t(maxd2), t(x1_in_c2), t(valid1), d1,
            t(maxd1), t(xy1), t(oct1), d1, t(valid1), t(xy2), t(oct2), d2,
            t(valid2), fx, fy, cx, cy, w, h, scale_factors,
            float(np.log(1.2)), L]


@pytest.mark.parametrize("case", ["test_sim3_match", "bad sim3", "random 1",
                                  "random 2"])
def test_match_by_sim3_equals_the_two_hamming_composition(case,
                                                          monkeypatch):
    """On the CPU match_by_sim3 runs match_rows' plain version in motion
    mode (band [-1, 0], no right-u gate, TH_HIGH): each direction's best
    and has, and the mutual matches, bit for bit the composition around
    two 2-D Hamming matrices it replaced."""
    import airdos_tpu_torch.matching.sim3_match as sm
    args = _sim3_inputs(case)
    calls = []
    directional = sm._directional

    def both(*a):
        got = directional(*a)
        calls.append((got, _sim3_directional(*a)))
        return got

    monkeypatch.setattr(sm, "_directional", both)
    res = sm.match_by_sim3(*args)
    assert len(calls) == 2
    for (best, has), (want_best, want_has) in calls:
        assert torch.equal(best, want_best) and torch.equal(has, want_has)
    bestA, hasA = calls[0][1]
    bestB, hasB = calls[1][1]
    f1 = torch.arange(bestB.shape[0])
    agree = hasB & hasA[bestB] & (bestA[bestB] == f1)
    assert torch.equal(res.idx2_of_1,
                       torch.where(agree, bestB, torch.full_like(bestB, -1)))
    assert int(res.n_matches) == int(agree.sum())
    if case != "bad sim3":
        assert int(res.n_matches) > 20


# ------------------------------------- the kernels' reductions in numpy

def _emulate_rows(mode, G, H, col_key, col_x, th, ratio, rng):
    """csrc/match.cu match_rows' reductions over a gate G [P, N] and
    distances H, the candidates met in column order: each lane keeps the
    two smallest keys (distance << 21 | column) of the gated columns it
    meets, the warp takes the minima; stereo's second is the least of the
    gated pairs the warp listed at > 1.5 px from best's u, and its column
    minima are complemented atomicMax in a random order, decoded and
    checked for mutuality by the last block."""
    P, N = G.shape
    out = {k: np.zeros(P, np.int64) for k in ("best", "dist", "second",
                                              "second_dist")}
    has = np.zeros(P, bool)
    stores = []                                   # (column, ~key)
    f32 = np.float32
    for p in range(P):
        k1, k2 = [NONE] * LANES, [NONE] * LANES
        listed = []
        for lane in range(LANES):
            for j in range(lane, N, LANES):
                if not G[p, j]:
                    continue
                key = int(H[p, j]) << mk.INDEX_BITS | j
                if key < k1[lane]:
                    k1[lane], k2[lane] = key, k1[lane]
                elif key < k2[lane]:
                    k2[lane] = key
                if mode == mk.STEREO:
                    listed.append(key)
                    stores.append((j, ~(int(H[p, j]) << mk.INDEX_BITS | p)
                                   & 0xFFFFFFFF))
        best = min(k1)
        if mode == mk.STEREO:
            xb = col_x[best & MASK]
            cand = [k for k in listed
                    if abs(f32(col_x[k & MASK] - xb)) > f32(1.5)] or [NONE]
        else:
            cand = [b if a == best else a for a, b in zip(k1, k2)]
        second = min(cand)
        bd, bi, sd, si = best >> mk.INDEX_BITS, best & MASK, \
            second >> mk.INDEX_BITS, second & MASK
        h = bd <= th
        fb, rs = f32(bd), f32(ratio)
        if mode == mk.LOCAL:
            h = h and not (col_key[bi] == col_key[si] and fb > rs * f32(sd)
                           and sd < mk.BIG)
        elif mode == mk.STEREO:
            h = h and fb < rs * f32(min(sd, 256))
        elif mode == mk.BOW:
            h = h and fb < rs * f32(sd)
        out["best"][p], out["dist"][p] = bi, bd
        out["second"][p], out["second_dist"][p] = si, sd
        has[p] = h
    col_best = np.zeros(0, np.int64)
    if mode == mk.STEREO:
        stored = np.zeros(N, np.int64)
        for i in rng.permutation(len(stores)):
            j, v = stores[i]
            stored[j] = max(stored[j], v)
        col_best = np.where(stored == 0, 0, ~stored & MASK)
        has &= col_best[out["best"]] == np.arange(P)
    return out, has, col_best


def _rows_case(case, rng):
    """(G, H, col_key, col_x) for a named case."""
    P, N = {"ragged": (37, 45), "one column": (19, 1),
            "one row": (1, 70)}.get(case, (48, 96))
    G = rng.uniform(size=(P, N)) < 0.3
    H = rng.integers(0, 257, (P, N))
    col_key = rng.integers(0, 4, N)
    col_x = rng.uniform(0, 40, N).astype(np.float32)
    if case == "all-BIG rows and columns":
        G[::3] = False
        G[:, ::4] = False
    elif case == "ties at best":
        H = rng.integers(10, 13, (P, N))
    elif case == "ties at second":
        H = np.full((P, N), 20)
        H[:, 5] = 7
    elif case == "far-u ties":
        H = rng.integers(30, 33, (P, N))
        col_x = np.round(rng.uniform(0, 6, N) * 2).astype(np.float32) / 2
        col_x[::5] += np.float32(1.5)             # exactly 1.5 px apart
    elif case == "nothing gated":
        G[:] = False
    return G, H, col_key, col_x


_ROWS_CASES = ["random", "all-BIG rows and columns", "ties at best",
               "ties at second", "far-u ties", "ragged", "one column",
               "one row", "nothing gated"]


@pytest.mark.parametrize("mode", [mk.LOCAL, mk.STEREO, mk.BOW, mk.MOTION])
@pytest.mark.parametrize("case", _ROWS_CASES)
def test_row_reduction_emulation_equals_plain_version(case, mode):
    rng = np.random.default_rng(10 * _ROWS_CASES.index(case) + mode)
    G, H, col_key, col_x = _rows_case(case, rng)
    th, ratio = {mk.MOTION: (100, 0.0), mk.LOCAL: (100, 0.8),
                 mk.STEREO: (74, 0.9), mk.BOW: (49, 0.7)}[mode]
    D = torch.where(torch.from_numpy(G), torch.from_numpy(H).to(torch.int32),
                    torch.full(G.shape, mk.BIG, dtype=torch.int32))
    want = mk.reduce_gated(mode, D, torch.from_numpy(col_key),
                           torch.from_numpy(col_x), th, ratio)
    got, has, col_best = _emulate_rows(mode, G, H, col_key, col_x, th,
                                       ratio, rng)
    for name in ("best", "dist", "second", "second_dist"):
        np.testing.assert_array_equal(got[name], getattr(want, name).numpy(),
                                      err_msg=name)
    np.testing.assert_array_equal(has, want.has.numpy())
    np.testing.assert_array_equal(col_best, want.col_best.numpy())
    # the plain version is torch.argmin / amin of the gated matrix
    np.testing.assert_array_equal(got["best"], torch.argmin(D, 1).numpy())
    np.testing.assert_array_equal(got["dist"], torch.amin(D, 1).numpy())
    if mode == mk.STEREO:
        np.testing.assert_array_equal(col_best, torch.argmin(D, 0).numpy())


@pytest.mark.parametrize("case", _ROWS_CASES)
def test_fuse_reduction_emulation_equals_plain_version(case):
    """Fuse mode's reductions (a warp a row of a target: the minimum of
    the lanes' least keys, feat_idx = best where dist <= TH_LOW) equal the
    plain version's argmin over a [B, P, N] gated matrix."""
    rng = np.random.default_rng(7 + _ROWS_CASES.index(case))
    Gs, Hs = zip(*[_rows_case(case, rng)[:2] for _ in range(3)])
    G, H = np.stack(Gs), np.stack(Hs)
    D = torch.where(torch.from_numpy(G), torch.from_numpy(H).to(torch.int32),
                    torch.full(G.shape, mk.BIG, dtype=torch.int32))
    want = mk.reduce_gated(mk.FUSE, D, None, None, 50, 0.0)
    keys = np.where(G, H << mk.INDEX_BITS | np.arange(G.shape[2]), NONE)
    lanes = [keys[..., lane::LANES].min(-1, initial=NONE)
             for lane in range(LANES)]
    best = np.minimum.reduce(lanes)
    np.testing.assert_array_equal(best & MASK, want.best.numpy())
    np.testing.assert_array_equal(best >> mk.INDEX_BITS, want.dist.numpy())
    np.testing.assert_array_equal(
        np.where(best >> mk.INDEX_BITS <= 50, best & MASK, -1),
        want.feat_idx.numpy())


def _bins(ang_ref, ang_cur):
    """The kernel's rotation bin in numpy float32."""
    f32 = np.float32
    rot = (ang_ref - ang_cur).astype(f32)
    rot = np.where(rot < 0, rot + f32(360), rot).astype(f32)
    binf = np.rint(rot * f32(mk.HISTO_BINS / 360.0))
    b = np.where(binf == mk.HISTO_BINS, 0, binf).astype(np.int64)
    return np.clip(b, 0, mk.HISTO_BINS - 1)


def _top3(hist):
    """csrc/match.cu resolve_rows' top 3 of a warp of 32 lanes (lane b
    holds bin b's count, lanes 30 and 31 none): three warp max-reductions
    of count << 5 | (31 - lane) over the bins not yet taken, so ties go to
    the lower bin, then the 0.1 * max cut -> keep [30]."""
    counts = [int(hist[b]) if b < mk.HISTO_BINS else -1 for b in range(32)]
    taken, val = [False] * 32, [0] * 32
    cut = None
    for _ in range(3):
        top = max((v << 5 | (31 - lane)) if v >= 0 and not taken[lane] else -1
                  for lane, v in enumerate(counts))
        if cut is None:
            cut = np.float32(0.1) * np.float32(top >> 5)
        taken[31 - (top & 31)] = True
        val[31 - (top & 31)] = top >> 5
    return np.array([taken[b] and np.float32(val[b]) >= cut
                     for b in range(mk.HISTO_BINS)])


def _emulate_resolve(best, dist, has, n_feats, bins, rng):
    """csrc/match.cu resolve_rows (the last block of match_rows): each
    row's bin once (-1 where it claims nothing), the histogram's top 3 by
    _top3, then each kept row's 32-bit key dist << 21 | row (a row farther
    than BIG kept out) atomicMin-ed in a random order into its feature's
    slot (unset: all ones)."""
    claim = has & (best >= 0) & (best < n_feats)
    k = np.where(claim, bins if bins is not None else 0, -1)
    keep = np.ones(mk.HISTO_BINS, bool)
    if bins is not None:
        keep = _top3(np.bincount(k[k >= 0], minlength=mk.HISTO_BINS))
    kept = (k >= 0) & keep[np.maximum(k, 0)] & (dist <= mk.BIG)
    unset = 0xFFFFFFFF
    key = (dist.astype(np.int64) << mk.INDEX_BITS | np.arange(len(best)))
    assert (key[kept] < unset).all()
    seg = [unset] * n_feats
    for p in rng.permutation(len(best)):
        if kept[p]:
            seg[best[p]] = min(seg[best[p]], int(key[p]))
    won = np.array([kept[p] and seg[best[p]] == key[p]
                    for p in range(len(best))], bool)
    feat_idx = np.where(won, best, -1)
    pof = np.array([-1 if s == unset else s & MASK for s in seg])
    return feat_idx, pof, int(won.sum())


_RESOLVE_CASES = ["random", "many ties", "farther than BIG", "ragged",
                  "no claims"]


@pytest.mark.parametrize("case", _RESOLVE_CASES)
@pytest.mark.parametrize("rotation", [False, True])
def test_resolve_emulation_equals_plain_version(case, rotation):
    rng = np.random.default_rng(2 * _RESOLVE_CASES.index(case) + rotation)
    P, n_feats = (77, 13) if case == "ragged" else (300, 64)
    best = rng.integers(0, n_feats, P)
    dist = rng.integers(0, 120, P)
    has = rng.uniform(size=P) < 0.7
    if case == "many ties":
        dist = rng.integers(0, 3, P)
    elif case == "farther than BIG":
        dist = rng.integers(mk.BIG - 2, mk.BIG + 3, P)
    elif case == "no claims":
        has[:] = False
    ang_ref = rng.uniform(0, 360, P).astype(np.float32)
    ang_tab = np.where(rng.uniform(size=n_feats) < 0.5,
                       rng.uniform(0, 360, n_feats),
                       (ang_ref[:n_feats] - 24) % 360).astype(np.float32)
    bins = _bins(ang_ref, ang_tab[best]) if rotation else None
    got = _emulate_resolve(best, dist, has, n_feats, bins, rng)
    want = mk.match_resolve_ref(
        torch.from_numpy(best), torch.from_numpy(dist.astype(np.int32)),
        torch.from_numpy(has), n_feats,
        torch.from_numpy(ang_ref) if rotation else None,
        torch.from_numpy(ang_tab))
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    assert got[2] == int(want[2])


# bin counts: a four-way tie at the top, a tie at the third, a third bin
# under 0.1 * max, a single bin, and bins 29 and 0 (rot near 360 and 0)
_HISTS = {"four-way tie": {3: 5, 7: 5, 11: 5, 20: 5},
          "tie at the third": {2: 9, 4: 3, 8: 3, 9: 3},
          "cut under 0.1 max": {5: 40, 6: 5, 19: 3},
          "one bin": {12: 7},
          "wrap": {0: 6, 29: 6, 15: 1}}


@pytest.mark.parametrize("kind", list(_HISTS))
def test_histogram_top3_ties_and_cut(kind, rng):
    counts = _HISTS[kind]
    ang_ref, ang_cur = [], []
    for b, n in counts.items():
        rot = (b * 12.0 + rng.uniform(-4, 4, n)) % 360
        if b == 0:
            rot = rng.choice([rng.uniform(356.5, 359.9, n),
                              rng.uniform(0.1, 4, n)])
        a = rng.uniform(0, 360, n)
        ang_ref += list(a)
        ang_cur += list((a - rot) % 360)
    ang_ref = np.asarray(ang_ref, np.float32)
    ang_cur = np.asarray(ang_cur, np.float32)
    has = np.ones(len(ang_ref), bool)
    has[-1] = False                                # one not counted
    bins = _bins(ang_ref, ang_cur)
    want_j = np.asarray(jproj._rotation_consistency(
        jnp.asarray(ang_ref), jnp.asarray(ang_cur), jnp.asarray(has)))
    want_t = mk.rotation_consistency(torch.from_numpy(ang_ref),
                                     torch.from_numpy(ang_cur),
                                     torch.from_numpy(has)).numpy()
    np.testing.assert_array_equal(want_t, want_j)
    # the emulated kernel: one feature a row, so uniqueness keeps them all
    n = len(ang_ref)
    feat_idx, _, _ = _emulate_resolve(np.arange(n), np.zeros(n, np.int64),
                                      has, n, bins, rng)
    np.testing.assert_array_equal(feat_idx >= 0, want_t)
    if kind == "cut under 0.1 max":
        assert not want_t[bins == 19].any() and want_t[bins == 6].all()


# ------------------------------------- the grid of cells, in numpy

REACH = np.float32(2 ** 20)             # csrc/match.cu kReach
LIST = 64                               # csrc/match.cu kList
f32 = np.float32


def _axis(lo, hi, n):
    """csrc/match.cu make_axis: (lo, inv, n), a cell at least a pixel."""
    if not lo <= hi:
        return f32(0), f32(0), n
    span = f32(hi - lo)
    return f32(lo), (f32(n) / span if span > f32(n) else f32(1)), n


def _cell(ax, z):
    """csrc/match.cu cell_of: clamp(floor((z - lo) * inv)), NaN to 0."""
    lo, inv, n = ax
    with np.errstate(invalid="ignore", over="ignore"):
        f = np.floor(f32(f32(z) - lo) * inv)
    return int(np.fmin(np.fmax(f, f32(0)), f32(n - 1)))


def _cell_range(ax, lo, hi):
    """csrc/match.cu cell_range: widened by a cell, or the whole axis."""
    if not (abs(lo) < REACH and abs(hi) < REACH):
        return 0, ax[2] - 1
    return max(_cell(ax, lo) - 1, 0), min(_cell(ax, hi) + 1, ax[2] - 1)


def _bucket(key, n):
    return ((int(key) % 2 ** 64) * 0x9E3779B97F4A7C15 % 2 ** 64 >> 32) % n


def _gate(mode, c, a, cx, cy, cw, ck):
    """csrc/match.cu gate at one candidate, float32 steps."""
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        if mode == mk.BOW:
            return ck == a["key"]
        if mode == mk.EPIPOLAR:
            l0, l1, l2 = a["line"]
            dn = f32(f32(f32(l0 * cx) + f32(l1 * cy)) + l2)
            return f32(f32(dn * dn) / a["den"]) < f32(f32(mk.EPI_CHI2) * cw)
        if mode == mk.STEREO:
            if not abs(f32(a["y"] - cy)) <= cw or abs(a["key"] - ck) > 1:
                return False
            disp = f32(a["x"] - cx)
            return f32(0) <= disp <= f32(c["max_d"])
        du, dv = f32(cx - a["x"]), f32(cy - a["y"])
        if not (abs(du) < a["radius"] and abs(dv) < a["radius"]):
            return False
        if mode == mk.FUSE:
            if ck < a["key"] - 1 or ck > a["key"] + 1:
                return False
            s2 = c["sigma2"][min(max(ck, 0), len(c["sigma2"]) - 1)]
            e2 = f32(f32(du * du) + f32(dv * dv))
            if cw >= 0:
                der = f32(cw - a["ur"])
                return f32(f32(e2 + f32(der * der)) / s2) <= f32(mk.CHI2_STEREO)
            return f32(e2 / s2) <= f32(mk.CHI2_MONO)
        lo, hi = c["band"]
        if lo is not None and ck < a["key"] + lo:
            return False
        if hi is not None and ck > a["key"] + hi:
            return False
        return not cw > 0 or abs(f32(a["ur"] - cw)) < a["radius"]


def _table(mode, cols, cells, rng):
    """csrc/match.cu build_table: the valid columns sorted into cells (in
    a random order within a cell, as the atomics leave them) -> (slots
    [n] of column indices, start [cells + 1], x axis, y axis, w_max, the
    rest of the Grid: the extent's upper ends and magnitudes, the cells'
    height, whether a valid finite column lies past REACH)."""
    gx, gy = cells
    valid = cols["ok"].copy()
    if cols.get("taken") is not None:
        valid &= ~cols["taken"]
    if mode == mk.BOW:
        valid &= cols["key"] >= 0
        cell = np.array([_bucket(k, gx) for k in cols["key"]])
        ax = ay = None
        w_max = extra = None
    else:
        x, y = cols["x"], cols["y"]
        with np.errstate(invalid="ignore"):
            fx, fy = valid & (np.abs(x) < REACH), valid & (np.abs(y) < REACH)
        x0, x1 = (x[fx].min(), x[fx].max()) if fx.any() else \
            (f32(np.inf), f32(-np.inf))
        y0, y1 = (y[fy].min(), y[fy].max()) if fy.any() else \
            (f32(np.inf), f32(-np.inf))
        ax, ay = _axis(x0, x1, gx), _axis(y0, y1, gy)
        with np.errstate(invalid="ignore"):
            far = valid & np.isfinite(x) & np.isfinite(y) & \
                ~((np.abs(x) < REACH) & (np.abs(y) < REACH))
        extra = dict(x_hi=f32(x1), y_hi=f32(y1),
                     x_mag=max(abs(f32(x0)), abs(f32(x1))),
                     y_mag=max(abs(f32(y0)), abs(f32(y1))),
                     cell_y=f32(1) / ay[1] if ay[1] > 0 else f32(1),
                     wide=bool(far.any()))
        ws = cols["w"][valid]
        ws = ws[~np.isnan(ws)]
        w_max = f32(ws.max()) if len(ws) else f32(-np.inf)
        cell = np.array([_cell(ay, y[j]) * gx + _cell(ax, x[j])
                         for j in range(len(x))])
    js = np.nonzero(valid)[0]
    js = js[np.lexsort((rng.uniform(size=len(js)), cell[js]))]
    start = np.concatenate([[0], np.cumsum(np.bincount(cell[js],
                                                       minlength=gx * gy))])
    return js, start, ax, ay, w_max, extra


def _epi_norm2(l0, l1):
    """csrc/match.cu epi_norm2: max(l0^2 + l1^2, 1e-12), a NaN kept."""
    with np.errstate(invalid="ignore", over="ignore"):
        d = f32(f32(l0 * l0) + f32(l1 * l1))
    return f32(mk.EPI_MIN_NORM2) if d < f32(mk.EPI_MIN_NORM2) else d


def _band_half_width(a, w_max, g):
    """csrc/match.cu band_half_width in float32 steps."""
    l0, l1, l2 = a["line"]
    with np.errstate(invalid="ignore", over="ignore"):
        reach = f32(f32(f32(abs(l0) * g["x_mag"]) + f32(abs(l1) * g["y_mag"]))
                    + abs(l2))
        return f32(f32(np.sqrt(f32(f32(f32(mk.EPI_CHI2) * w_max) * a["den"]))
                       * f32(1.001)) + f32(f32(1e-5) * reach))


def _band_cells(a, h, cy, ax, ay, g, widen=1):
    """csrc/match.cu band_cells: the cells of row of cells cy that the
    band reaches, widened by `widen` cells (the kernel's 1) in x and in
    y -> (c0, c1), c1 < c0 where none."""
    l0, l1, l2 = a["line"]
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        ya = f32(ay[0] + f32(f32(cy - widen) * g["cell_y"]))
        yb = f32(ay[0] + f32(f32(cy + 1 + widen) * g["cell_y"]))
        p, r = f32(l1 * ya), f32(l1 * yb)
        lo_v = f32(f32(-h - l2) - max(p, r))
        hi_v = f32(f32(h - l2) - min(p, r))
        if l0 > 0:
            xl, xh = f32(lo_v / l0), f32(hi_v / l0)
        elif l0 < 0:
            xl, xh = f32(hi_v / l0), f32(lo_v / l0)
        else:
            xl = f32(-np.inf) if lo_v <= 0 and hi_v >= 0 else f32(np.inf)
            xh = -xl
    if np.isnan(xl) or np.isnan(xh):
        return 0, ax[2] - 1
    if xh < ax[0] or xl > g["x_hi"]:
        return 0, -1
    return (max(_cell(ax, max(xl, ax[0])) - widen, 0),
            min(_cell(ax, min(xh, g["x_hi"])) + widen, ax[2] - 1))


def _window(mode, c, a, ax, ay, w_max, gx, g=None, widen=1):
    """A row's candidate slots, in the order its warp's lanes meet them
    (the ranges of cells concatenated; candidate t to lane t % 32)."""
    if mode == mk.BOW:
        b = _bucket(a["key"], gx)
        return [(b, b, 0, 1)]
    if mode == mk.EPIPOLAR:
        h = _band_half_width(a, w_max, g)
        if g["wide"] or not np.isfinite(h):
            return [(0, ax[2] - 1, 0, ay[2])]
        return [(c0, c1, cy, int(c1 >= c0)) for cy in range(ay[2])
                for c0, c1 in [_band_cells(a, h, cy, ax, ay, g, widen)]]
    with np.errstate(invalid="ignore", over="ignore"):
        if mode == mk.STEREO:
            xs = (f32(a["x"] - f32(c["max_d"])), a["x"])
            ys = (f32(a["y"] - w_max), f32(a["y"] + w_max))
        else:
            r = a["radius"]
            xs = (f32(a["x"] - r), f32(a["x"] + r))
            ys = (f32(a["y"] - r), f32(a["y"] + r))
    cx0, cx1 = _cell_range(ax, *xs)
    cy0, cy1 = _cell_range(ay, *ys)
    return [(cx0, cx1, cy0, max(cy1 - cy0 + 1, 0) if cx1 >= cx0 else 0)]


def _emulate_grid(c, cells, rng, widen=1):
    """csrc/match.cu match_rows (and its resolve) on numpy case c: the grid
    of cells, each row's window walked a candidate a lane, the exact gate,
    the gated columns' distances a column a lane in the order the warp
    compacted them, the two smallest keys a lane and the warp's minima;
    stereo's far-u
    second from the warp's list of gated pairs (a second walk where the
    list overflows), the column minima as complemented atomicMax in a
    random order and the last block's mutual check; fuse's batch of
    targets and feat_idx, and epipolar's (each row's line a target, its
    band's cells a row of cells, widened by `widen` cells); the resolve as
    _emulate_resolve."""
    mode, rows, cols = c["mode"], c["rows"], c["cols"]
    fuse = mode == mk.FUSE
    batched = mode in mk.BATCHED
    B = cols["desc"].shape[0] if batched else 1
    P = rows["desc"].shape[0]
    gx, gy = cells
    out = {k: np.zeros((B, P), np.int64) for k in ("best", "dist", "second",
                                                    "second_dist")}
    has = np.zeros((B, P), bool)
    stores = []
    for b in range(B):
        cb = {k: (v[b] if batched else v) for k, v in cols.items()
              if v is not None}
        js, start, ax, ay, w_max, gd = _table(mode, cb, cells, rng)
        pc = np.array([bin(int(w)).count("1") for w in range(256)])
        cdesc = cb["desc"].view(np.uint8)
        rdesc = rows["desc"].view(np.uint8)
        for p in range(P):
            a = {k: (v[b, p] if (fuse and k != "desc") or k == "line"
                     else v[p]) for k, v in rows.items() if v is not None}
            if mode == mk.EPIPOLAR:
                a["den"] = _epi_norm2(*a["line"][:2])
            ok = a["ok"] and not (mode == mk.BOW and a["key"] < 0)
            slots = []
            if ok:
                for cx0, cx1, cy0, nr in _window(mode, c, a, ax, ay, w_max,
                                                 gx, gd, widen):
                    for r in range(nr):
                        base = (cy0 + r) * gx
                        slots += list(range(start[base + cx0],
                                            start[base + cx1 + 1]))
            k1, k2 = [NONE] * LANES, [NONE] * LANES
            listed = []
            gated = [js[s] for s in slots if _gate(
                mode, c, a, None if mode == mk.BOW else cb["x"][js[s]],
                None if mode == mk.BOW else cb["y"][js[s]],
                None if mode == mk.BOW else cb["w"][js[s]], cb["key"][js[s]])]
            for g, j in enumerate(gated):
                lane = g % LANES            # the flush's lane of a gated column
                d = int(pc[rdesc[p] ^ cdesc[j]].sum())
                key = d << mk.INDEX_BITS | int(j)
                if key < k1[lane]:
                    k1[lane], k2[lane] = key, k1[lane]
                elif key < k2[lane]:
                    k2[lane] = key
                if mode == mk.STEREO:
                    listed.append((key, cb["x"][j]))
                    stores.append((int(j), ~(d << mk.INDEX_BITS | p)
                                   & 0xFFFFFFFF))
            best = min(k1)
            if mode == mk.STEREO:
                second = NONE
                if best != NONE:
                    # past LIST gated pairs the warp walks its window
                    # again and meets the same pairs
                    xb = cb["x"][best & MASK]
                    with np.errstate(invalid="ignore"):
                        far = [k for k, x in listed if abs(f32(x - xb)) > f32(1.5)]
                    second = min(far, default=NONE)
            else:
                second = min(b2 if b1 == best else b1 for b1, b2 in zip(k1, k2))
            bd, bi, sd, si = best >> mk.INDEX_BITS, best & MASK, \
                second >> mk.INDEX_BITS, second & MASK
            h = bd <= c["th"]
            fb, rs = f32(bd), f32(c["ratio"])
            if mode == mk.LOCAL:
                h = h and not (cb["key"][bi] == cb["key"][si] and
                               fb > rs * f32(sd) and sd < mk.BIG)
            elif mode == mk.STEREO:
                h = h and fb < rs * f32(min(sd, 256))
            elif mode == mk.BOW:
                h = h and fb < rs * f32(sd)
            out["best"][b, p], out["dist"][b, p] = bi, bd
            out["second"][b, p], out["second_dist"][b, p] = si, sd
            has[b, p] = h
    res = {k: v if batched else v[0] for k, v in out.items()}
    has = has if batched else has[0]
    if batched:
        return dict(best=res["best"], dist=res["dist"], has=has,
                    feat_idx=np.where(has, res["best"], -1))
    res["has"] = has
    N = cols["desc"].shape[0]
    if mode == mk.STEREO:
        stored = np.zeros(N, np.int64)
        for i in rng.permutation(len(stores)):
            j, v = stores[i]
            stored[j] = max(stored[j], v)
        res["col_best"] = np.where(stored == 0, 0, ~stored & MASK)
        res["has"] = has & (res["col_best"][res["best"]] == np.arange(P))
    if c["resolve"]:
        bins = _bins(*(c["angles"][0], c["angles"][1][res["best"]])) \
            if c["angles"] is not None else None
        res["feat_idx"], res["point_of_feat"], res["n"] = _emulate_resolve(
            res["best"], res["dist"], res["has"], N, bins, rng)
    return res


_GRIDS = {"64 x 48": None, "8 x 6": (8, 6), "one cell": (1, 1)}


@pytest.mark.parametrize("grid", list(_GRIDS))
@pytest.mark.parametrize("case", tcases.CASES)
@pytest.mark.parametrize("mode", tcases.MODES)
def test_grid_walk_emulation_equals_plain_version(mode, case, grid):
    """The kernel's walk over its grid of cells, emulated in numpy, gives
    every output of the plain version (the dense gate and argmins) in
    every mode, on the grid's edge cases, at the kernel's grid, a coarse
    one and a single cell (the full scan)."""
    m = tcases.MODES.index(mode)
    rng = np.random.default_rng(100 * m + 10 * tcases.CASES.index(case)
                                + list(_GRIDS).index(grid))
    c = tcases.make(m, case, rng, 48, 96, 3)
    cells = _GRIDS[grid] or mk.CELLS[m]
    if m == mk.BOW and grid == "8 x 6":
        cells = (7, 1)
    got = _emulate_grid(c, cells, rng)
    want = mk.match_rows_ref(*tcases.args(c))
    for name, g in got.items():
        np.testing.assert_array_equal(g, getattr(want, name).numpy(),
                                      err_msg=name)
    if case == "path":
        assert want.has.sum() > 5


@pytest.mark.parametrize("widen", [0, 2])
def test_epipolar_band_widened_or_not_keeps_every_gated_pair(widen):
    """Epipolar mode's band (csrc/match.cu band_cells), emulated with the
    cells' widening the kernel does not have (0: the band's own cells; 2:
    two cells each side), gives every output of the plain version on every
    case: the band's half-width margins alone hold every gated pair, the
    kernel's cell each side is room to spare.  Shrunk by a cell (-1) the
    emulation loses pairs, so these cases can see a band too narrow."""
    m = mk.EPIPOLAR
    lost = []
    for case in tcases.CASES:
        rng = np.random.default_rng(300 + tcases.CASES.index(case))
        c = tcases.make(m, case, rng, 48, 96, 3)
        want = mk.match_rows_ref(*tcases.args(c))
        for w in (widen, -1):
            got = _emulate_grid(c, mk.CELLS[m], rng, widen=w)
            same = all(np.array_equal(g, getattr(want, name).numpy())
                       for name, g in got.items())
            if w == widen:
                assert same, case
            elif not same:
                lost.append(case)
    assert len(lost) >= 4, lost


@pytest.mark.parametrize("seed", range(6))
def test_warp_top3_equals_the_stable_sort(seed):
    """The folded resolve's top 3 (three warp max-reductions) keeps the
    bins the plain version's stable descending sort keeps, on histograms
    full of ties."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, [2, 3, 5, 20, 200, 1][seed], mk.HISTO_BINS)
    counts = torch.from_numpy(hist)
    top = torch.sort(counts, descending=True, stable=True)
    ok = top.values[:3].to(torch.float32) >= \
        0.1 * top.values[0].to(torch.float32)
    keep = torch.zeros(mk.HISTO_BINS, dtype=torch.bool)
    keep[top.indices[:3]] = ok
    np.testing.assert_array_equal(_top3(hist), keep.numpy())


# --------------------------------------------------------- the roundings

@pytest.mark.parametrize("ratio", [0.7, 0.75, 0.8, 0.9])
def test_ratio_product_is_float32_of_the_rounded_ratio(ratio):
    """The kernels' __fmul_rn(float32(ratio), float32(second)) is torch's
    ratio * second.to(float32), for every second the matchers see."""
    second = torch.arange(0, mk.BIG + 1, dtype=torch.int32)
    got = (ratio * second.to(torch.float32)).numpy()
    want = np.float32(ratio) * second.numpy().astype(np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_bin_scale_product_is_float32(rng):
    """torch's rot * (30 / 360.0) is the float32 product with the scale
    rounded to float32 (the kernel's bin_scale), and torch.round is rint."""
    rot = rng.uniform(0, 360, 100000).astype(np.float32)
    rot[:7] = [0.0, 6.0, 18.0, 354.0, 359.99997, 12.000001, 17.999998]
    got = torch.round(torch.from_numpy(rot) * (mk.HISTO_BINS / 360.0))
    want = np.rint(rot * np.float32(mk.HISTO_BINS / 360.0))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------ the dispatchers

def test_cpu_tensors_take_the_plain_versions(scene, monkeypatch):
    """On CPU tensors the matchers never reach the kernel's wrapper, and
    the wrapper raises on CPU tensors (no launch is counted)."""
    cam, (a, b) = scene

    def kernel(*args, **kwargs):
        raise AssertionError("a kernel wrapper ran on CPU tensors")

    n_rows, n_resolve = mk.launches(), mk.resolve_launches()
    with monkeypatch.context() as m:
        m.setattr(mk, "match_rows_cuda", kernel)
        got = _run_stereo(a, cam, "torch")
    assert (got["best_right"] >= 0).sum() > 100
    rows = mk.MatchRows(_t(a["desc_l"].view(np.int32)), _t(a["oct_l"]).long(),
                        _t(a["valid_l"]))
    cols = mk.MatchCols(_t(b["desc_l"].view(np.int32)), _t(b["oct_l"]).long(),
                        _t(b["valid_l"]))
    with pytest.raises(ValueError):
        mk.match_rows_cuda(mk.BOW, rows, cols, 49, 0.7)
    with pytest.raises(ValueError):
        mk.match_rows_cuda(mk.BOW, rows, cols, 49, 0.7, resolve=True)
    assert (mk.launches(), mk.resolve_launches()) == (n_rows, n_resolve)
