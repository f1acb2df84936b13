"""The port's bag-of-words layer against airdos_tpu (CPU).

Both packages get the same numpy descriptors (ORB features of two
small-world frames from the port's front end).  Stated tolerances:
- train_vocabulary: the same tree (node words, children, word ids) and
  idf weights, array for array; transform: identical word ids, node ids
  and BoW vectors;
- match_by_bow: idx2 equal on >= 99% of the features either side matched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airdos_tpu.bow.vocabulary import train_vocabulary as jax_train
from airdos_tpu.matching.bow_match import match_by_bow as jax_match
from airdos_tpu_torch.bow.vocabulary import Vocabulary, train_vocabulary
from airdos_tpu_torch.config import SlamConfig
from airdos_tpu_torch.convert import desc_to_tensor, vocabulary_from
from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld, small_camera
from airdos_tpu_torch.matching.bow_match import match_by_bow
from airdos_tpu_torch.slam.frame import FrontEnd
from airdos_tpu_torch.slam.keyframe_db import KeyFrameDatabase
from airdos_tpu_torch.slam.map import KeyFrame, SlamMap


@pytest.fixture(scope="module")
def feats():
    """Valid ORB features of frames 0 and 2 (descriptors, angles)."""
    cfg = SlamConfig()
    cfg.camera = small_camera()
    cfg.orb.n_features = 600
    cfg.orb.n_levels = 4
    cfg.device.max_keypoints = 1024
    fe = FrontEnd(cfg)
    world = SyntheticStereoWorld(seed=0, n_points=200, cam=cfg.camera)
    seq = [d for d, _, _ in world.sequence(3, dt=0.1, yaw_rate=0.008)]
    return [fe.build_frame(seq[i]) for i in (0, 2)]


@pytest.fixture(scope="module")
def vocabs(feats):
    f = feats[0]
    d = f.desc32[f.valid]
    train = d.view(np.uint8).reshape(len(d), 32)
    assert len(train) >= 200
    # System's scene vocabulary: k=8, depth=3
    return jax_train(train, k=8, depth=3), train_vocabulary(train, k=8,
                                                            depth=3)


def test_train_vocabulary_builds_the_same_tree(vocabs):
    jv, tv = vocabs
    for name in ("node_desc32", "children", "word_id", "weights"):
        np.testing.assert_array_equal(getattr(tv, name), getattr(jv, name),
                                      err_msg=name)
    assert (tv.k, tv.depth, tv.n_words, tv.feature_level) == \
        (jv.k, jv.depth, jv.n_words, jv.feature_level)
    np.testing.assert_array_equal(tv._group_of_node, jv._group_of_node)


@pytest.mark.parametrize("frame", [0, 1])
def test_transform_is_identical(vocabs, feats, frame):
    jv, tv = vocabs
    f = feats[frame]
    bow_j, w_j, n_j = jv.transform(f.desc32, f.valid)
    bow_t, w_t, n_t = tv.transform(f.desc32, f.valid)
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_array_equal(n_t, n_j)
    assert bow_t == bow_j
    assert Vocabulary.score(bow_t, bow_t) == pytest.approx(1.0)


def test_vocabulary_carried_across_and_through_npz(vocabs, feats, tmp_path):
    jv, tv = vocabs
    f = feats[1]
    cv = vocabulary_from(jv)
    tv.save_npz(tmp_path / "voc.npz")
    lv = Vocabulary.load_npz(tmp_path / "voc.npz")
    want = tv.transform(f.desc32, f.valid)
    for v in (cv, lv):
        got = v.transform(f.desc32, f.valid)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])


def test_match_by_bow_matches_jax(vocabs, feats):
    _, tv = vocabs
    f1, f2 = feats
    _, _, n1 = tv.transform(f1.desc32, f1.valid)
    _, _, n2 = tv.transform(f2.desc32, f2.valid)
    ref = jax.device_get(jax.jit(jax_match)(
        jnp.asarray(f1.desc32), jnp.asarray(n1), jnp.asarray(f1.valid),
        jnp.asarray(f1.angle), jnp.asarray(f2.desc32), jnp.asarray(n2),
        jnp.asarray(f2.valid), jnp.asarray(f2.angle)))
    t = torch.from_numpy
    out = match_by_bow(
        desc_to_tensor(f1.desc32, "cpu"), t(n1.astype(np.int64)),
        t(f1.valid), t(f1.angle), desc_to_tensor(f2.desc32, "cpu"),
        t(n2.astype(np.int64)), t(f2.valid), t(f2.angle))
    a, b = out.idx2.numpy(), np.asarray(ref.idx2)
    either = (a >= 0) | (b >= 0)
    assert either.sum() > 30
    assert np.mean(a[either] == b[either]) >= 0.99
    assert int(out.n_matches) == int((a >= 0).sum())


def test_keyframe_database_inverted_file(vocabs, feats):
    _, tv = vocabs
    m = SlamMap()
    kfs = []
    for i, f in enumerate(feats):
        kf = KeyFrame(i, f)
        m.add_keyframe(kf)
        kfs.append(kf)
    db = KeyFrameDatabase(tv, m)
    for kf in kfs:
        db.add(kf)
        db.add(kf)                       # a second add is a no-op
    assert kfs[0].bow and kfs[0].feat_nodes.shape == (kfs[0].n_slots,)
    words = set(kfs[0].bow) | set(kfs[1].bow)
    assert set(w for w, s in db.inverted.items() if s) == words
    db.erase(kfs[0])
    assert all(0 not in db.inverted[w] for w in kfs[0].bow)
    assert all(1 in db.inverted[w] for w in kfs[1].bow)
    db.clear()
    assert not db.inverted and not kfs[1]._in_db
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        db.detect_loop_candidates(kfs[1], 0.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        db.detect_reloc_candidates(kfs[1].bow)
