"""The port's place recognition and loop correction against airdos_tpu
(CPU), on identical state.  Stated tolerances:

- DBoW2 loaders: a vocabulary written by airdos_tpu's save_dbow2_binary,
  and a small DBoW2 text file, load in the port with equal tables
  (exactly) and the same transform (word and node ids exactly, BoW
  weights within 1e-6); the port's own binary round trip is exact; the
  text loader writes airdos_tpu's ``<path>.npz`` cache.
- match_by_sim3 on tests/test_sim3_match.py's two-camera geometry, right
  and wrong Sim3: the mutual matches exactly.
- detect_loop_candidates / detect_reloc_candidates for every keyframe of
  a carried map, and LoopCloser.detect over a keyframe sequence with the
  closer's state carried: the same candidate lists in the same order.
- LoopCloser.correct on tests/test_loop_correction.py's 24-keyframe
  drifted circle from the same sim3 result: every keyframe pose within
  1e-4 (R) / 1e-4 m (t) and every point within 1e-4 m (20 float32 LM
  steps on the 168 x 168 essential graph; airdos_tpu pads it to 224 with
  fixed identity vertices, which change no free vertex beyond float32
  rounding).
"""
import copy
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airdos_tpu.bow.vocabulary import save_dbow2_binary as jax_save_bin
from airdos_tpu.bow.vocabulary import train_vocabulary as jax_train
from airdos_tpu.config import SlamConfig as JaxConfig
from airdos_tpu.io.synthetic import small_camera
from airdos_tpu.matching.sim3_match import match_by_sim3 as jax_sim3_match
from airdos_tpu.slam.keyframe_db import KeyFrameDatabase as JaxDB
from airdos_tpu.slam.loop_closing import LoopCloser as JaxLoopCloser
from airdos_tpu.slam.map import KeyFrame as JaxKeyFrame
from airdos_tpu.slam.map import SlamMap as JaxMap
from airdos_tpu_torch.bow.vocabulary import (Vocabulary, load_dbow2_binary,
                                             load_dbow2_text,
                                             save_dbow2_binary)
from airdos_tpu_torch.convert import (config_from, desc_to_tensor,
                                      loop_closer_state_from, map_from,
                                      vocabulary_from)
from airdos_tpu_torch.matching.sim3_match import match_by_sim3
from airdos_tpu_torch.slam.keyframe_db import KeyFrameDatabase
from airdos_tpu_torch.slam.loop_closing import LoopCloser

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_loop_correction import _FakeFrame, _yaw  # noqa: E402
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _descs(rng, n):
    return rng.integers(0, 256, (n, 32), dtype=np.uint8)


def _u32(d):
    return np.ascontiguousarray(d).view(np.uint32).reshape(-1, 8)


def _assert_same_vocabulary(tv, jv, rng):
    for name in ("node_desc32", "children", "word_id", "weights"):
        np.testing.assert_array_equal(getattr(tv, name), getattr(jv, name))
    assert (tv.k, tv.depth, tv.n_words, tv.feature_level) == \
        (jv.k, jv.depth, jv.n_words, jv.feature_level)
    d = _u32(_descs(rng, 200))
    bt, wt, nt = tv.transform(d)
    bj, wj, nj = jv.transform(d)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(nt, nj)
    assert bt.keys() == bj.keys()
    np.testing.assert_allclose([bt[w] for w in bt], [bj[w] for w in bt],
                               atol=1e-6)


def test_dbow2_binary_from_airdos_tpu_loads(tmp_path):
    rng = np.random.default_rng(0)
    from airdos_tpu.bow.vocabulary import load_dbow2_binary as jax_load_bin
    jax_save_bin(jax_train(_descs(rng, 600), k=4, depth=3),
                 tmp_path / "voc.bin")
    jv = jax_load_bin(tmp_path / "voc.bin")
    tv = load_dbow2_binary(tmp_path / "voc.bin", device="cpu")
    _assert_same_vocabulary(tv, jv, rng)
    # the port's own round trip: byte-identical file, equal tables
    save_dbow2_binary(tv, tmp_path / "again.bin")
    assert (tmp_path / "again.bin").read_bytes() == \
        (tmp_path / "voc.bin").read_bytes()
    _assert_same_vocabulary(load_dbow2_binary(tmp_path / "again.bin",
                                              device="cpu"), jv, rng)


def test_dbow2_text_loads_like_airdos_tpu(tmp_path):
    """A small DBoW2 text file (k=3, L=2): the root's 3 children, each
    with 2 or 3 leaves; both packages load it alike and the port writes
    the .npz cache beside it, which a second load reads."""
    from airdos_tpu.bow.vocabulary import load_dbow2_text as jax_load_text
    rng = np.random.default_rng(1)
    lines = ["3 2 0 0"]
    parents = [0, 0, 0, 1, 1, 2, 2, 2, 3, 3]
    for i, p in enumerate(parents):
        leaf = int(i >= 3)
        d = " ".join(str(int(x)) for x in _descs(rng, 1)[0])
        lines.append(f"{p} {leaf} {d} {0.5 + 0.1 * i if leaf else 0.0}")
    (tmp_path / "voc.txt").write_text("\n".join(lines) + "\n")
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "voc.txt").write_text("\n".join(lines) + "\n")
    jv = jax_load_text(tmp_path / "jax" / "voc.txt")
    tv = load_dbow2_text(tmp_path / "voc.txt", device="cpu")
    assert tv.n_words == 7 and (tmp_path / "voc.txt.npz").exists()
    _assert_same_vocabulary(tv, jv, rng)
    cached = load_dbow2_text(tmp_path / "voc.txt", device="cpu")
    _assert_same_vocabulary(cached, jv, rng)
    assert isinstance(cached, Vocabulary)


@pytest.mark.parametrize("bad_sim3", [False, True])
def test_match_by_sim3_matches_jax(bad_sim3):
    rng = np.random.default_rng(2)
    N = 64
    fx = fy = 320.0
    cx, cy, w, h = 160.0, 120.0, 320, 240
    pts = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                    rng.uniform(5, 15, N)], axis=1).astype(np.float32)
    R2 = _yaw(0.1)
    t2 = np.array([0.5, 0.1, -0.3], np.float32)
    x1, x2 = pts, pts @ R2.T + t2
    R12, t12 = R2.T, -R2.T @ t2
    if bad_sim3:
        t12 = t12 + np.array([3.0, 2.0, 0.0], np.float32)
    desc = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32)
    desc[7::7] = desc[:-7:7]                         # some repeated words
    xy1 = np.stack([fx * x1[:, 0] / x1[:, 2] + cx,
                    fy * x1[:, 1] / x1[:, 2] + cy], 1).astype(np.float32)
    xy2 = np.stack([fx * x2[:, 0] / x2[:, 2] + cx,
                    fy * x2[:, 1] / x2[:, 2] + cy], 1).astype(np.float32)
    oct_ = rng.integers(0, 3, N).astype(np.int32)
    valid = rng.uniform(size=N) > 0.1
    sf = np.asarray([1.2 ** i for i in range(4)], np.float32)
    x2c1 = (x2 @ R12.T + t12).astype(np.float32)
    x1c2 = ((x1 - t12) @ R12).astype(np.float32)
    maxd1 = (1.1 * np.linalg.norm(x1c2, axis=1)).astype(np.float32)
    maxd2 = (1.1 * np.linalg.norm(x2c1, axis=1)).astype(np.float32)
    args = [x2c1, valid, desc, maxd2, x1c2, valid, desc, maxd1,
            xy1, oct_, desc, valid, xy2, oct_, desc, valid]
    want = jax_sim3_match(*(jnp.asarray(a) for a in args), fx, fy, cx, cy,
                          w, h, jnp.asarray(sf), float(np.log(1.2)), 4)
    port_args = [desc_to_tensor(a, "cpu") if a is desc else
                 _t(a.astype(np.int64) if a is oct_ else a) for a in args]
    got = match_by_sim3(*port_args, fx, fy, cx, cy, w, h, _t(sf),
                        float(np.log(1.2)), 4)
    np.testing.assert_array_equal(got.idx2_of_1.numpy(),
                                  np.asarray(want.idx2_of_1))
    assert int(got.n_matches) == int(want.n_matches)
    if bad_sim3:
        assert int(want.n_matches) < 0.2 * N
    else:
        assert int(want.n_matches) > 40


def _place_map():
    """A keyframe sequence over a pool of descriptors: keyframe i draws
    from the pool window [60 i, 60 i + 240), so neighbours share words,
    and the last four revisit the first windows (a loop).  Covisibility
    links consecutive keyframes."""
    rng = np.random.default_rng(3)
    pool = _descs(rng, 2000)
    voc = jax_train(pool, k=6, depth=3)
    m = JaxMap()
    n_kf, n_slots = 18, 240
    for i in range(n_kf):
        base = 60 * (i if i < n_kf - 4 else i - (n_kf - 4))
        f = _FakeFrame(i, n_slots, np.eye(3, dtype=np.float32),
                       np.zeros(3, np.float32))
        sel = (base + rng.permutation(240)[:n_slots]) % len(pool)
        f.desc32 = _u32(pool[sel])
        kf = JaxKeyFrame(i, f)
        m.add_keyframe(kf)
        m.next_kf_id = i + 1
        if i > 0:
            w = 120 - 5 * (i % 3)
            kf.covis = {i - 1: w}
            m.kfs[i - 1].covis[i] = w
            kf.ordered_covis = [i - 1]
            m.kfs[i - 1].ordered_covis = sorted(
                m.kfs[i - 1].covis, key=lambda k: -m.kfs[i - 1].covis[k])
            kf.parent = i - 1
            m.kfs[i - 1].children.add(i)
    return voc, m


def test_candidate_detection_matches_jax_on_a_carried_map():
    jvoc, jm = _place_map()
    tm = map_from(jm)
    tvoc = vocabulary_from(jvoc, device="cpu")
    jdb, tdb = JaxDB(jvoc, jm), KeyFrameDatabase(tvoc, tm)
    n_cands = 0
    for kid in sorted(jm.kfs):
        jdb.add(jm.kfs[kid])
        tdb.add(tm.kfs[kid])
    assert {w: set(s) for w, s in jdb.inverted.items() if s} == \
        {w: set(s) for w, s in tdb.inverted.items() if s}
    for kid in sorted(jm.kfs):
        want = jdb.detect_reloc_candidates(jm.kfs[kid].bow)
        assert tdb.detect_reloc_candidates(tm.kfs[kid].bow) == want
        for min_score in (0.0, 0.05):
            want_l = jdb.detect_loop_candidates(jm.kfs[kid], min_score)
            assert tdb.detect_loop_candidates(tm.kfs[kid], min_score) == \
                want_l
            n_cands += len(want_l)
    assert n_cands > 0


def _extractor(n_levels=4):
    class _Ext:
        scales = tuple(1.2 ** i for i in range(n_levels))
        sigma2 = np.asarray([1.2 ** (2 * i) for i in range(n_levels)],
                            np.float32)
    return _Ext()


def test_loop_closer_detect_matches_jax_with_carried_state():
    """The carried closer continues detection from airdos_tpu's state:
    the keyframes after the carry point give the same consistent
    candidates in both packages."""
    jvoc, jm = _place_map()
    cfg = JaxConfig()
    cfg.camera = small_camera()
    jlc = JaxLoopCloser(cfg, jm, JaxDB(jvoc, jm), _extractor())
    jlc.consistency_th = 1
    order = sorted(jm.kfs)
    for kid in order[:12]:
        jlc.detect(jm.kfs[kid])
    jlc.rng.integers(0, 10, 5)                # move the generator on
    tm = map_from(jm)
    tvoc = vocabulary_from(jvoc, device="cpu")
    tdb = KeyFrameDatabase(tvoc, tm)
    for kid in order[:12]:
        tdb.add(tm.kfs[kid])
    tlc = LoopCloser(config_from(cfg), tm, tdb, _extractor(), "cpu")
    tlc.consistency_th = 1
    loop_closer_state_from(jlc, tlc)
    assert tlc.rng.integers(0, 1000) == copy.deepcopy(jlc.rng).integers(0, 1000)
    found = 0
    for kid in order[12:]:
        want = jlc.detect(jm.kfs[kid])
        assert tlc.detect(tm.kfs[kid]) == want
        assert [(g, c) for g, c in tlc._consistent_groups] == \
            [(set(g), c) for g, c in jlc._consistent_groups]
        found += len(want)
    assert found > 0


def _drifted_circle(KeyFrame, SlamMap, N=24):
    """tests/test_loop_correction.py's map: 24 keyframes on a circle with
    yaw + translation drift, a parent chain with covisibility 150, three
    points per keyframe; and the loop's S12 from the true geometry."""
    m = SlamMap()
    true_R, true_t, est_R, est_t = [], [], [], []
    for i in range(N):
        th = 2 * np.pi * i / N
        Rcw = _yaw(th).T
        tcw = -Rcw @ np.array([4 * (1 - np.cos(th)), 0.0, 4 * np.sin(th)])
        true_R.append(Rcw)
        true_t.append(tcw.astype(np.float32))
        frac = i / (N - 1)
        dR = _yaw(0.1 * frac)
        est_R.append((dR @ Rcw).astype(np.float32))
        est_t.append((dR @ tcw + np.array([0.6, 0.1, 0.3]) * frac)
                     .astype(np.float32))
    for i in range(N):
        kf = KeyFrame(i, _FakeFrame(i, 8, est_R[i], est_t[i]))
        m.add_keyframe(kf)
        m.next_kf_id = i + 1
        if i > 0:
            kf.parent = i - 1
            m.kfs[i - 1].children.add(i)
            kf.covis = {i - 1: 150}
            m.kfs[i - 1].covis[i] = 150
            kf.ordered_covis = [i - 1]
            m.kfs[i - 1].ordered_covis.append(i)
    for i in range(N):
        kf = m.kfs[i]
        pos = (-kf.Rcw.T @ kf.tcw)[None, :] + \
            np.asarray([[0.0, 0.0, 2.0 + 0.1 * j] for j in range(3)])
        m.create_points(kf, np.arange(3), pos.astype(np.float32))
    R12 = true_R[N - 1] @ m.kfs[0].Rcw.T
    t12 = true_t[N - 1] - R12 @ m.kfs[0].tcw
    return m, (R12.astype(np.float32), t12.astype(np.float32), 1.0, {}, 0, [])


class _DummyDB:
    class voc:
        @staticmethod
        def score(a, b):
            return 0.0

    def ensure_bow(self, kf):
        pass

    def add(self, kf):
        pass


def test_loop_correct_matches_jax_on_the_drifted_circle():
    from airdos_tpu_torch.slam.map import KeyFrame, SlamMap
    cfg = JaxConfig()
    cfg.camera = small_camera()
    jm, res = _drifted_circle(JaxKeyFrame, JaxMap)
    tm, res_t = _drifted_circle(KeyFrame, SlamMap)
    jlc = JaxLoopCloser(cfg, jm, _DummyDB(), _extractor())
    tlc = LoopCloser(config_from(cfg), tm, _DummyDB(), _extractor(), "cpu")
    before = np.stack([tm.kfs[i].tcw for i in range(24)])
    assert jlc.correct(jm.kfs[23], res)
    assert tlc.correct(tm.kfs[23], res_t)
    for i in range(24):
        np.testing.assert_allclose(tm.kfs[i].Rcw, jm.kfs[i].Rcw, atol=1e-4)
        np.testing.assert_allclose(tm.kfs[i].tcw, jm.kfs[i].tcw, atol=1e-4)
        assert tm.kfs[i].loop_edges == jm.kfs[i].loop_edges
    n = jm.points.n
    np.testing.assert_allclose(tm.points.pos[:n], jm.points.pos[:n],
                               atol=1e-4)
    moved = np.linalg.norm(np.stack([tm.kfs[i].tcw for i in range(24)]) -
                           before, axis=1)
    assert moved[8:16].mean() > 0.05 and tlc.n_loops_closed == 1
