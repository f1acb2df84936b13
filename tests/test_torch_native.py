"""The port's map bookkeeping host functions (airdos_tpu_torch/native)
against airdos_tpu/native's C++ extension and an independent numpy
reference (CPU).

Every result here is an integer (row indices, counts, distances), so each
is held exactly: the distinctive descriptor is the first row of least
median Hamming distance (MapPoint::ComputeDistinctiveDescriptors,
reference src/MapPoint.cc:245-310), whatever the grouping and chunking of
the batch.  The comparisons with the extension skip where its committed
build does not load (as tests/test_native_runtime.py does).  SlamMap's
batched refresh is held against its own per-point refresh and against
airdos_tpu's SlamMap on the same map state, made from one numpy seed.
"""
import numpy as np
import pytest

from airdos_tpu.slam import map as jax_map
from airdos_tpu_torch import native
from airdos_tpu_torch.slam import map as port_map
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture
def nat():
    return pytest.importorskip("airdos_tpu.native.airdos_native")


def _reference(D):
    """min-median-Hamming over uint8 [N, 32] rows, by np.unpackbits."""
    dist = np.unpackbits(D[:, None, :] ^ D[None, :, :], axis=-1).sum(-1)
    med = np.sort(dist, axis=1)[:, (len(D) - 1) // 2]
    return int(np.argmin(med))


def _blocks(rng, sizes):
    D = rng.integers(0, 256, (int(sum(sizes)), 32)).astype(np.uint8)
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return D, off


def _near(rng, center, n, flips):
    """n copies of a descriptor, each with `flips` random bits flipped."""
    rows = np.repeat(center[None], n, axis=0)
    for r in rows:
        bits = rng.choice(256, flips, replace=False)
        np.bitwise_xor.at(r, bits // 8, (1 << (bits % 8)).astype(np.uint8))
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_matches_the_numpy_reference(seed):
    """Random blocks of 0-17 observations: each winner is the reference's
    row of its block, as an absolute row; -1 for an empty block."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 18, 60)
    sizes[:3] = (0, 1, 17)
    D, off = _blocks(rng, sizes)
    got = native.distinctive_descriptors_batch(D, off)
    assert got.dtype == np.int64 and got.shape == (len(sizes),)
    for k, (lo, hi) in enumerate(zip(off[:-1], off[1:])):
        want = lo + _reference(D[lo:hi]) if hi > lo else -1
        assert got[k] == want, k


@pytest.mark.parametrize("seed", [3, 4])
def test_batch_matches_airdos_native(nat, seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 18, 80)
    D, off = _blocks(rng, sizes)
    np.testing.assert_array_equal(
        native.distinctive_descriptors_batch(D, off),
        nat.distinctive_descriptors_batch(D, off))
    for lo, hi in zip(off[:-1], off[1:]):
        assert native.distinctive_descriptor(D[lo:hi]) == \
            nat.distinctive_descriptor(np.ascontiguousarray(D[lo:hi]))


def test_single_point_and_empty(nat):
    rng = np.random.default_rng(5)
    D = rng.integers(0, 256, (9, 32)).astype(np.uint8)
    assert native.distinctive_descriptor(D) == _reference(D) == \
        nat.distinctive_descriptor(D)
    assert native.distinctive_descriptor(D[:0]) == -1 == \
        nat.distinctive_descriptor(D[:0])
    empty = native.distinctive_descriptors_batch(
        D[:0], np.zeros(3, np.int64))
    np.testing.assert_array_equal(empty, [-1, -1])


def test_ties_go_to_the_first_row(nat):
    """Identical descriptors: the first row wins; two equal best rows
    among noisy copies: the first of them; two rows: the first."""
    rng = np.random.default_rng(6)
    center = rng.integers(0, 256, 32).astype(np.uint8)
    same = np.repeat(center[None], 7, axis=0)
    noisy = _near(rng, center, 9, 12)
    noisy[3] = noisy[6] = center
    pair = rng.integers(0, 256, (2, 32)).astype(np.uint8)
    blocks = [same, noisy, pair]
    D = np.concatenate(blocks)
    off = np.concatenate([[0], np.cumsum([len(b) for b in blocks])])
    got = native.distinctive_descriptors_batch(D, off.astype(np.int64))
    np.testing.assert_array_equal(got, [0, 7 + 3, 16])
    np.testing.assert_array_equal(
        got, nat.distinctive_descriptors_batch(D, off.astype(np.int64)))
    for b in blocks:
        assert native.distinctive_descriptor(b) == _reference(b)


def test_batch_steps_through_a_large_group(monkeypatch):
    """A group taken in steps of a few points gives the same winners."""
    rng = np.random.default_rng(7)
    sizes = np.array([12] * 25 + [5] * 9 + [12] * 6)
    D, off = _blocks(rng, sizes)
    whole = native.distinctive_descriptors_batch(D, off)
    monkeypatch.setattr(native, "_STEP_BYTES", 3 * 32 * 12 * 12)
    np.testing.assert_array_equal(
        native.distinctive_descriptors_batch(D, off), whole)
    assert whole[0] == _reference(D[:12])


def test_descriptor_functions_reject_other_layouts():
    D = np.zeros((4, 32), np.uint8)
    for bad in (D.astype(np.int32), D[:, :16], D[None]):
        with pytest.raises(ValueError):
            native.distinctive_descriptor(bad)
        with pytest.raises(ValueError):
            native.distinctive_descriptors_batch(bad, np.array([0, 4]))
    with pytest.raises(ValueError):
        native.distinctive_descriptors_batch(D, np.array([0, 4], np.int32))
    with pytest.raises(ValueError):
        native.hamming_matrix_u8(D, D[:, :8])


def test_covisibility_counts_match_airdos_native(nat):
    rng = np.random.default_rng(8)
    lists = [rng.integers(0, 12, rng.integers(0, 9)).astype(np.int64)
             for _ in range(40)]
    got = native.covisibility_counts(lists, 3)
    assert got == nat.covisibility_counts(lists, 3)
    ids = np.concatenate(lists)
    assert got == {int(k): int((ids == k).sum()) for k in set(ids) - {3}}
    assert native.covisibility_counts([], 0) == nat.covisibility_counts(
        [], 0) == {}
    with pytest.raises(TypeError):
        native.covisibility_counts(tuple(lists), 3)
    with pytest.raises(TypeError):
        native.covisibility_counts([lists[0].astype(np.int32)], 3)


@pytest.mark.parametrize("n,m", [(37, 11), (0, 5), (1, 1)])
def test_hamming_matrix_u8_matches_airdos_native(nat, n, m):
    rng = np.random.default_rng(n * 31 + m)
    a = rng.integers(0, 256, (n, 32)).astype(np.uint8)
    b = rng.integers(0, 256, (m, 32)).astype(np.uint8)
    got = native.hamming_matrix_u8(a, b)
    assert got.dtype == np.int32 and got.shape == (n, m)
    np.testing.assert_array_equal(got, nat.hamming_matrix_u8(a, b))
    np.testing.assert_array_equal(
        got, np.unpackbits(a[:, None] ^ b[None], axis=-1).sum(-1))


# ---------------------------------------------------------------- SlamMap

class _Frame:
    """The measurement arrays a KeyFrame takes, made from rng."""

    def __init__(self, idx, desc32):
        n = desc32.shape[0]
        self.index = idx
        self.timestamp = 0.1 * idx
        self.xy = np.zeros((n, 2), np.float32)
        self.xy_un = np.zeros((n, 2), np.float32)
        self.octave = np.zeros(n, np.int32)
        self.angle = np.zeros(n, np.float32)
        self.response = np.ones(n, np.float32)
        self.desc32 = desc32
        self.u_right = np.full(n, -1.0, np.float32)
        self.depth = np.full(n, 1.0, np.float32)
        self.valid = np.ones(n, bool)
        self.mp_idx = np.full(n, -1, np.int64)
        self.Rcw = np.eye(3, dtype=np.float32)
        self.tcw = np.zeros(3, np.float32)


def _map_state(seed, n_kfs=18, n_feat=48, n_pts=40):
    """(keyframe descriptors, points' creating keyframe and slot, extra
    observations, the bad keyframe): points seen by 1-17 keyframes, some
    descriptors repeated across keyframes (ties), a culled keyframe, and
    points seen only by it."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2 ** 32, (n_feat, 8), dtype=np.uint64)
    descs = []
    for k in range(n_kfs):
        d = base ^ (rng.random((n_feat, 8)) < 0.02) * rng.integers(
            0, 2 ** 32, (n_feat, 8), dtype=np.uint64)
        descs.append(d.astype(np.uint32))
    descs[5] = descs[4].copy()
    made = [(int(rng.integers(0, n_kfs)), j) for j in range(n_pts)]
    bad_kf = 7
    made[:3] = [(bad_kf, 0), (bad_kf, 1), (bad_kf, 2)]
    extra = []
    for j in range(3, n_pts):
        others = rng.choice(n_kfs, int(rng.integers(0, n_kfs)),
                            replace=False)
        extra.append([(int(k), j) for k in others if k != made[j][0]])
    return descs, made, extra, bad_kf


def _build(mod, state):
    descs, made, extra, bad_kf = state
    m = mod.SlamMap()
    kfs = [mod.KeyFrame(k, _Frame(k, d)) for k, d in enumerate(descs)]
    for kf in kfs:
        m.add_keyframe(kf)
    pids = []
    for k, j in made:
        pids += [int(p) for p in m.create_points(
            kfs[k], np.array([j]), np.array([[0.0, 0.0, 1.0]], np.float32))]
    for j, obs in zip(range(3, len(made)), extra):
        for k, fid in obs:
            m.add_observation(pids[j], kfs[k], fid)
    kfs[bad_kf].bad = True
    m.points.desc32[pids] = 0          # so that a refresh shows
    return m, pids


@pytest.mark.parametrize("seed", [0, 1])
def test_map_batched_refresh_matches_its_per_point_refresh(seed,
                                                           monkeypatch):
    """One batch call a refresh; each point's descriptor that of the
    per-point refresh; a point seen only by a culled keyframe keeps its
    descriptor."""
    state = _map_state(seed)
    m, pids = _build(port_map, state)
    calls = []
    batch = native.distinctive_descriptors_batch
    monkeypatch.setattr(native, "distinctive_descriptors_batch",
                        lambda *a: calls.append(1) or batch(*a))
    m.update_point_descriptors(pids)
    assert len(calls) == 1
    got = m.points.desc32[pids].copy()
    assert not got[:3].any() and got[3:].any(axis=1).all()
    one, _ = _build(port_map, state)
    for p in pids:
        one.update_point_descriptor(p)
    np.testing.assert_array_equal(got, one.points.desc32[pids])


@pytest.mark.parametrize("seed", [2, 3])
def test_map_batched_refresh_matches_airdos_tpu(seed):
    """The same map state in airdos_tpu's SlamMap (the C++ batch where its
    build loads, else its numpy fallback) and in the port's: the same
    descriptors, batched and per point."""
    state = _map_state(seed)
    jm, jpids = _build(jax_map, state)
    tm, tpids = _build(port_map, state)
    assert jpids == tpids
    jm.update_point_descriptors(jpids)
    tm.update_point_descriptors(tpids)
    np.testing.assert_array_equal(tm.points.desc32[tpids],
                                  jm.points.desc32[jpids])
    jm, _ = _build(jax_map, state)
    for p in jpids:
        jm.update_point_descriptor(p)
    np.testing.assert_array_equal(tm.points.desc32[tpids],
                                  jm.points.desc32[jpids])
