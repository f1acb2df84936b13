"""Tests of the port that need an NVIDIA card (marker ``cuda``).

They skip where torch sees no CUDA device.  On a machine with a card and
no JAX, run them without the repository's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import airdos_tpu_torch.ops.hamming_kernels as hk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,m", [(1, 1), (63, 65), (1536, 1536), (2048, 1337)])
def test_hamming_kernel_equals_plain_version(cuda, n, m):
    rng = np.random.default_rng(n * 7919 + m)
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint64).astype(np.uint32)
    ta = torch.from_numpy(a.view(np.int32)).to(cuda)
    tb = torch.from_numpy(b.view(np.int32)).to(cuda)
    before = hk.launches()
    got = hk.hamming_matrix(ta, tb)
    torch.cuda.synchronize()
    assert hk.launches() == before + 1
    assert torch.equal(got, hk.hamming_matrix_ref(ta, tb))
    assert torch.equal(got.cpu(), hk.hamming_matrix_ref(ta.cpu(), tb.cpu()))


def test_hamming_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.zeros((4, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        hk.hamming_matrix(a, a)
    with pytest.raises(ValueError):
        hk.hamming_matrix(a.to(torch.int32)[:, :4], a.to(torch.int32)[:, :4])


def _words(rng, shape):
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("ba,bb,n,m", [(1, 4, 1536, 1536), (1, 9, 2048, 1536),
                                       (3, 3, 65, 63), (5, 1, 7, 130)])
def test_batched_hamming_kernel_equals_plain_version(cuda, ba, bb, n, m):
    rng = np.random.default_rng(ba * 131 + bb * 7 + n)
    ta = torch.from_numpy(_words(rng, (ba, n, 8)).view(np.int32)).to(cuda)
    tb = torch.from_numpy(_words(rng, (bb, m, 8)).view(np.int32)).to(cuda)
    before = hk.batched_launches()
    got = hk.hamming_matrix_batched(ta, tb)
    torch.cuda.synchronize()
    assert hk.batched_launches() == before + 1
    assert got.shape == (max(ba, bb), n, m)
    assert torch.equal(got.cpu(),
                       hk.hamming_matrix_batched_ref(ta.cpu(), tb.cpu()))


@pytest.mark.parametrize("s,k", [(24, 36), (2048, 9), (24, 6), (2048, 3),
                                 (49152, 18), (5, 2)])
def test_segment_sum_kernel_bitwise_and_deterministic(cuda, s, k):
    import airdos_tpu_torch.ops.segment_kernels as sk
    rng = np.random.default_rng(s + k)
    E = 8192
    key = rng.integers(0, s, E)
    key[:400] = 0                         # a long segment
    keep = np.ones(E, bool)
    keep[-2000:] = False                  # padding rows, summed nowhere
    vals = rng.normal(0, 1, (E, k)).astype(np.float32)
    tk = torch.from_numpy(key).to(cuda)
    tv = torch.from_numpy(vals).to(cuda)
    seg = sk.make_segments(tk, s, torch.from_numpy(keep).to(cuda))
    before = sk.launches()
    got1 = sk.segment_sum(tv, seg)
    got2 = sk.segment_sum(tv, seg)
    torch.cuda.synchronize()
    assert sk.launches() == before + 2
    want = sk.segment_sum_ref(tv.cpu(), seg.key.cpu(), s)
    assert torch.equal(got1.cpu(), want)
    assert torch.equal(got1, got2)


_RAGGED = [1, 15, 17, 127, 1500, 1536, 2048]


def _special(rng, kind, shape):
    """uint32 words: random, all ones, or random with the sign bit set
    (negative int32 bit views); the first rows stay random."""
    w = _words(rng, shape)
    if kind == "ones":
        w[..., 3:, :] = 0xFFFFFFFF
    elif kind == "sign":
        w[..., 3:, :] |= np.uint32(0x80000000)
    return w


@pytest.mark.parametrize("m", _RAGGED)
@pytest.mark.parametrize("n", _RAGGED)
def test_hamming_kernel_exact_at_ragged_shapes(cuda, n, m):
    rng = np.random.default_rng(n * 4099 + m)
    kind_a, kind_b = ("ones", "sign") if (n + m) % 2 else ("sign", "sign")
    ta = torch.from_numpy(_special(rng, kind_a, (n, 8)).view(np.int32)).to(cuda)
    tb = torch.from_numpy(_special(rng, kind_b, (m, 8)).view(np.int32)).to(cuda)
    got = hk.hamming_matrix(ta, tb)
    torch.cuda.synchronize()
    assert got.shape == (n, m)
    assert torch.equal(got, hk.hamming_matrix_ref(ta, tb))


@pytest.mark.parametrize("kind", ["random", "ones", "sign"])
@pytest.mark.parametrize("ba,bb,n,m", [(1, 4, 1500, 17), (1, 9, 2048, 1536),
                                       (4, 1, 127, 1500), (3, 3, 15, 2048),
                                       (2, 2, 1, 1)])
def test_batched_hamming_kernel_exact_at_ragged_shapes(cuda, ba, bb, n, m,
                                                       kind):
    rng = np.random.default_rng(ba * 17 + bb * 5 + n + m)
    ta = torch.from_numpy(_special(rng, kind, (ba, n, 8)).view(np.int32))
    tb = torch.from_numpy(_special(rng, kind, (bb, m, 8)).view(np.int32))
    got = hk.hamming_matrix_batched(ta.to(cuda), tb.to(cuda))
    torch.cuda.synchronize()
    assert got.shape == (max(ba, bb), n, m)
    assert torch.equal(got, hk.hamming_matrix_batched_ref(ta.to(cuda),
                                                          tb.to(cuda)))


def test_hamming_kernel_takes_operands_not_on_16_bytes(cuda):
    """The kernel reads descriptors as 16-byte vectors; an operand that
    starts 4 bytes into its storage is copied first, and the result is
    exact."""
    rng = np.random.default_rng(5)
    flat = torch.from_numpy(_words(rng, (1 + 300 * 8,)).view(np.int32)).to(cuda)
    a = flat[1:].view(300, 8)
    assert a.data_ptr() % 16 != 0
    b = torch.from_numpy(_words(rng, (257, 8)).view(np.int32)).to(cuda)
    got = hk.hamming_matrix(a, b)
    got_batched = hk.hamming_matrix_batched(a[None], b[None])
    torch.cuda.synchronize()
    want = hk.hamming_matrix_ref(a, b)
    assert torch.equal(got, want) and torch.equal(got_batched[0], want)


def _segment_case(rng, case, k):
    """(keys, keep, n_segments) of one segment_sum card case."""
    if case == "one long segment":        # longer than a shared-memory chunk
        return np.zeros(5000, np.int64), np.ones(5000, bool), 1
    if case == "empty segments":          # every other camera sees nothing
        key = 2 * rng.integers(0, 12, 8192)
        return key, np.ones(8192, bool), 24
    if case == "rows keyed n":            # padding, dropped
        key = rng.integers(0, 24, 8192)
        keep = rng.random(8192) > 0.3
        return key, keep, 24
    if case == "many short segments":     # the point-keyed shape
        return rng.integers(0, 2048, 8192), rng.random(8192) > 0.1, 2048
    raise ValueError(case)


@pytest.mark.parametrize("k", [3, 9, 12, 18, 42])
@pytest.mark.parametrize("case", ["one long segment", "empty segments",
                                  "rows keyed n", "many short segments"])
def test_segment_sum_kernel_cases_bitwise_and_deterministic(cuda, case, k):
    import airdos_tpu_torch.ops.segment_kernels as sk
    rng = np.random.default_rng(k)
    key, keep, s = _segment_case(rng, case, k)
    # magnitudes over six decades, so that the order of the adds shows
    vals = (rng.normal(0, 1, (len(key), k)) *
            10.0 ** rng.uniform(-3, 3, (len(key), 1))).astype(np.float32)
    seg = sk.make_segments(torch.from_numpy(key).to(cuda), s,
                           torch.from_numpy(keep).to(cuda))
    tv = torch.from_numpy(vals).to(cuda)
    got1 = sk.segment_sum(tv, seg)
    got2 = sk.segment_sum(tv, seg)
    torch.cuda.synchronize()
    want = sk.segment_sum_ref(torch.from_numpy(vals), seg.key.cpu(), s)
    assert torch.equal(got1.cpu(), want)
    assert torch.equal(got1, got2)
    if case == "empty segments":
        assert (got1[1::2] == 0).all()


def test_mapping_system_runs_are_byte_identical_on_the_card(cuda, tmp_path):
    from airdos_tpu_torch.config import SlamConfig
    from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld, small_camera
    from airdos_tpu_torch.slam.system import System

    def config():
        cfg = SlamConfig()
        cfg.camera = small_camera()
        cfg.orb.n_features = 600
        cfg.orb.n_levels = 4
        cfg.device.max_keypoints = 1024
        cfg.device.max_local_kfs = 8
        cfg.device.max_fixed_kfs = 4
        cfg.device.max_local_points = 1024
        cfg.device.max_ba_edges = 4096
        return cfg

    world = SyntheticStereoWorld(seed=0, n_points=200, cam=small_camera())
    frames = [d for d, _, _ in world.sequence(8, dt=0.1, yaw_rate=0.008)]
    out = []
    for tag in ("a", "b"):
        slam = System(config(), device=cuda)
        for d in frames:
            slam.track_stereo(d)
        slam.save_trajectory_tum(tmp_path / f"traj_{tag}.txt")
        slam.before_end(tmp_path / f"dump_{tag}")
        slam.shutdown()
        assert slam.static_ba.n_solves > 0
        out.append([(tmp_path / f"traj_{tag}.txt").read_bytes()] +
                   [(tmp_path / f"dump_{tag}" / f).read_bytes()
                    for f in ("KF.txt", "MP.txt", "Match.txt")])
    assert out[0] == out[1]


def _human_problem(rng, C=4, P=80, L=6):
    """tests/test_human_ba.py's build_problem (one walking human seen from
    static cameras, static points), without JAX: the arguments of
    human_bundle_adjust."""
    from airdos_tpu_torch.slam.map import BODY1, BODY2
    skel = np.array([
        [0.00, -0.70, 0.00], [0.00, -0.50, 0.00], [-0.20, -0.50, 0.00],
        [-0.25, -0.25, 0.00], [-0.28, 0.00, 0.00], [0.20, -0.50, 0.00],
        [0.25, -0.25, 0.00], [0.28, 0.00, 0.00], [-0.12, 0.10, 0.00],
        [-0.14, 0.50, 0.00], [-0.15, 0.90, 0.00], [0.12, 0.10, 0.00],
        [0.14, 0.50, 0.00], [0.15, 0.90, 0.00]], np.float32)
    fx, cx, cy, bf = 400.0, 160.0, 120.0, 100.0
    cam_t = np.stack([[-0.3 * c, 0, 0] for c in range(C)]).astype(np.float32)
    pts = rng.uniform([-4, -3, 4], [4, 3, 20], (P, 3)).astype(np.float32)

    def project(x, c):
        xc = x + cam_t[c]
        u = fx * xc[:, 0] / xc[:, 2] + cx
        return np.stack([u, fx * xc[:, 1] / xc[:, 2] + cy,
                         u - bf / xc[:, 2]], 1)

    es_cam = np.repeat(np.arange(C), P).astype(np.int32)
    es_pt = np.tile(np.arange(P), C).astype(np.int32)
    es_obs = np.concatenate([project(pts, c) for c in range(C)])
    es_obs = (es_obs + rng.normal(0, 0.3, es_obs.shape)).astype(np.float32)
    joints = np.stack([skel + [0.5 + 0.2 * l, 0.2, 8.0 - 0.1 * l]
                       for l in range(L)])[None].astype(np.float32)
    jo_cam = (np.arange(L) % C)[None].astype(np.int32)
    jo_obs = np.stack([project(joints[0, l], jo_cam[0, l])
                       for l in range(L)])[None]
    jo_obs = (jo_obs + rng.normal(0, 0.5, jo_obs.shape)).astype(np.float32)
    joints0 = joints + rng.normal(0, 0.05, joints.shape).astype(np.float32)
    seg0 = np.linalg.norm(joints0[0, 0, BODY1] - joints0[0, 0, BODY2],
                          axis=1)[None]
    ones = np.ones((1, L, 14), bool)
    cam_fixed = np.arange(C) < 2
    arrays = (np.tile(np.eye(3, dtype=np.float32), (C, 1, 1)), cam_t,
              cam_fixed, pts + rng.normal(0, 0.05, pts.shape).astype(np.float32),
              np.ones(P, bool), es_cam, es_pt, es_obs,
              np.ones(C * P, np.float32), np.ones(C * P, bool),
              joints0, ones, jo_cam, jo_obs, ones, seg0.astype(np.float32),
              np.ones((1, 14), bool), ones, np.eye(3, dtype=np.float32)[None],
              np.zeros((1, 3), np.float32), np.ones(1, bool),
              np.full((1, L), 0.5, np.float32), np.ones((1, L, 5), bool))
    return arrays, (1.0, 0.5, 20.0, 20.0, 1.0, 4.0, 1.0,
                    fx, fx, cx, cy, bf)


def test_human_bundle_adjust_card_matches_cpu(cuda):
    """The card's solve against the CPU's on one problem: inlier flags
    equal, joints within 1e-2 m (median 1e-4 m: the float32 floor that
    tests/test_torch_human.py states), cameras within 1e-5 m; 60
    segment-sum launches; two card solves bit-equal."""
    import airdos_tpu_torch.ops.segment_kernels as sk
    from airdos_tpu_torch.solvers.human_ba import human_bundle_adjust
    arrays, scalars = _human_problem(np.random.default_rng(0))
    cpu = human_bundle_adjust(*(torch.from_numpy(a) for a in arrays),
                              *scalars)
    before = sk.launches()
    card = [human_bundle_adjust(*(torch.from_numpy(a).to(cuda)
                                  for a in arrays), *scalars)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert sk.launches() == before + 120
    for a, b in zip(card[0], card[1]):
        assert torch.equal(a, b)
    got = [x.cpu() for x in card[0]]
    for i in (7, 8, 9, 10):                   # the four inlier-flag arrays
        assert torch.equal(got[i], cpu[i]), i
    assert (got[1] - cpu.cam_t).abs().max() < 1e-5
    gap = (got[3] - cpu.joints).norm(dim=-1)
    assert gap.max() < 1e-2 and gap.median() < 1e-4


def test_compact_human_scatter_at_full_width(cuda):
    """The human families' scatter at bench.py's full width (24 cameras,
    8 trajectories x 8 poses: 174,496 rows of one column) on the card:
    bit-equal to the plain version on a CPU copy and launch to launch."""
    import airdos_tpu_torch.ops.segment_kernels as sk
    from airdos_tpu_torch.solvers import human_ba as hba
    T, L, C = 8, 8, 24
    rng = np.random.default_rng(8)
    exists = torch.ones((T, L, 14), dtype=torch.bool, device=cuda)
    jo_cam = torch.from_numpy(rng.integers(-1, C, (T, L))).to(cuda)
    ed = hba.human_edges(jo_cam, torch.zeros((T, L, 14, 3), device=cuda),
                         exists, exists, exists,
                         torch.ones(T, dtype=torch.bool, device=cuda),
                         torch.full((T, L), 0.2, device=cuda),
                         torch.ones((T, L, 5), dtype=torch.bool,
                                    device=cuda), C)
    D = 6 * C + 42 * T * L + 20 * T
    keys, keep = hba.scatter_keys(ed.gidx, (ed.hp_valid, ed.rg_valid,
                                            ed.mo_valid), D)
    assert keys.shape[0] == 174496
    seg, pos = sk.make_compact_segments(keys, keep)
    vals = torch.from_numpy((rng.normal(0, 1, (keys.shape[0], 1)) *
                             10.0 ** rng.uniform(-3, 3, (keys.shape[0], 1)))
                            .astype(np.float32)).to(cuda)
    got1, got2 = sk.segment_sum(vals, seg), sk.segment_sum(vals, seg)
    torch.cuda.synchronize()
    want = sk.segment_sum_ref(vals.cpu(), seg.key.cpu(), seg.n)
    assert torch.equal(got1.cpu(), want) and torch.equal(got1, got2)
    assert int(pos.max()) < D * D + D and seg.n == pos.shape[0]


def test_patch_disparity_ties_on_the_card(cuda):
    """SAD minima tie on a texture that repeats every 16 px: the card's
    argmin takes the first, as the CPU's does."""
    from airdos_tpu_torch.ops.disparity import patch_disparity
    rng = np.random.default_rng(4)
    imL = np.tile(rng.integers(0, 255, (60, 16)), (1, 8)).astype(np.float32)
    imR = np.roll(imL, -5, axis=1)
    px = torch.tensor([[100.0, 30.0], [90.5, 20.5], [101.5, 40.0],
                       [60.0, 29.5], [3.0, 10.0], [-4.0, 2.0]])
    cpu = patch_disparity(torch.from_numpy(imL), torch.from_numpy(imR), px)
    card = patch_disparity(torch.from_numpy(imL).to(cuda),
                           torch.from_numpy(imR).to(cuda), px.to(cuda))
    assert torch.equal(card.cpu(), cpu)
    assert (cpu[:4].round() == 5).all() and (cpu[4:] == -1).all()


def _gba_corridor(rng, C=60, P=1500, per_cam=60):
    """A corridor of C cameras along z over P points, per_cam stereo
    observations each (tests/test_global_ba.py's layout)."""
    ctr = np.stack([0.01 * np.arange(C), np.zeros(C), 0.25 * np.arange(C)], 1)
    pts = np.stack([rng.uniform(-6, 6, P), rng.uniform(-4, 4, P),
                    rng.uniform(2, 0.25 * C + 10, P)], 1).astype(np.float32)
    cams, pids, obs = [], [], []
    for c in range(C):
        xc = pts - ctr[c]
        z = np.where(xc[:, 2] > 0.1, xc[:, 2], 1.0)
        u = 300.0 * xc[:, 0] / z + 160.0
        v = 300.0 * xc[:, 1] / z + 120.0
        ok = (xc[:, 2] > 1) & (xc[:, 2] < 25) & (u > 0) & (u < 320) & \
            (v > 0) & (v < 240)
        sel = rng.permutation(np.nonzero(ok)[0])[:per_cam]
        cams.append(np.full(len(sel), c))
        pids.append(sel)
        obs.append(np.stack([u[sel], v[sel], u[sel] - 60.0 / z[sel]], 1) +
                   rng.normal(0, 0.2, (len(sel), 3)))
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    t = (-ctr + np.linspace(0, 1, C)[:, None] * [0.2, 0.1, 0.15]) \
        .astype(np.float32)
    E = sum(map(len, cams))
    fixed = np.zeros(C, bool)
    fixed[0] = True
    return (R, t, fixed, pts + rng.normal(0, 0.05, pts.shape).astype(np.float32),
            np.ones(P, bool), np.concatenate(cams).astype(np.int32),
            np.concatenate(pids).astype(np.int32),
            np.concatenate(obs).astype(np.float32), np.ones(E, np.float32),
            np.ones(E, bool))


def test_global_ba_segment_sums_bitwise_and_deterministic(cuda, monkeypatch):
    """Every segment sum of a global BA step on the card, at its camera-
    and point-keyed shapes (42, 12, 42, 3, 6, 3 columns), bit-equal to the
    plain version on a CPU copy; two solves bit-equal."""
    import airdos_tpu_torch.ops.segment_kernels as sk
    from airdos_tpu_torch.solvers import global_ba as gba
    rng = np.random.default_rng(0)
    arrays = _gba_corridor(rng)
    dev = [torch.from_numpy(a).to(cuda) for a in arrays]
    seen = []
    real = gba.segment_sum

    def checked(vals, seg):
        out = real(vals, seg)
        want = sk.segment_sum_ref(vals.cpu(), seg.key.cpu(), seg.n)
        seen.append((tuple(vals.shape), torch.equal(out.cpu(), want)))
        return out

    monkeypatch.setattr(gba, "segment_sum", checked)
    res1 = gba.global_bundle_adjust(*dev, 300.0, 300.0, 160.0, 120.0, 60.0,
                                    iters1=1, iters2=1)
    monkeypatch.setattr(gba, "segment_sum", real)
    res2 = gba.global_bundle_adjust(*dev, 300.0, 300.0, 160.0, 120.0, 60.0,
                                    iters1=1, iters2=1)
    assert len(seen) == 2 * gba.launches_per_step(48)
    assert {k for (_, k), _ in seen} == {42, 12, 3, 6}
    assert all(ok for _, ok in seen)
    for a, b in zip(res1, res2):
        assert torch.equal(a, b)


def _drifted_circle_map(N=24):
    """tests/test_loop_correction.py's 24-keyframe drifted circle in the
    port's map, and the loop's sim3 result."""
    from types import SimpleNamespace

    from airdos_tpu_torch.slam.map import KeyFrame, SlamMap

    def yaw(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)

    m = SlamMap()
    true_R, true_t = [], []
    for i in range(N):
        th = 2 * np.pi * i / N
        Rcw = yaw(th).T
        tcw = -Rcw @ np.array([4 * (1 - np.cos(th)), 0.0, 4 * np.sin(th)])
        true_R.append(Rcw)
        true_t.append(tcw)
        frac = i / (N - 1)
        n = 8
        f = SimpleNamespace(
            index=i, timestamp=i * 0.5, xy=np.zeros((n, 2), np.float32),
            xy_un=np.zeros((n, 2), np.float32), octave=np.zeros(n, np.int32),
            angle=np.zeros(n, np.float32), response=np.ones(n, np.float32),
            desc32=np.zeros((n, 8), np.uint32),
            u_right=np.full(n, -1.0, np.float32),
            depth=np.full(n, -1.0, np.float32), valid=np.ones(n, bool),
            mp_idx=np.full(n, -1, np.int64),
            Rcw=(yaw(0.1 * frac) @ Rcw).astype(np.float32),
            tcw=(yaw(0.1 * frac) @ tcw + np.array([0.6, 0.1, 0.3]) * frac)
            .astype(np.float32))
        kf = KeyFrame(i, f)
        m.add_keyframe(kf)
        m.next_kf_id = i + 1
        if i > 0:
            kf.parent = i - 1
            m.kfs[i - 1].children.add(i)
            kf.covis = {i - 1: 150}
            m.kfs[i - 1].covis[i] = 150
            kf.ordered_covis = [i - 1]
            m.kfs[i - 1].ordered_covis.append(i)
        pos = kf.Ow[None, :] + np.array([[0.0, 0.0, 2.0 + 0.1 * j]
                                         for j in range(3)])
        m.create_points(kf, np.arange(3), pos.astype(np.float32))
    R12 = true_R[N - 1] @ m.kfs[0].Rcw.T
    t12 = true_t[N - 1] - R12 @ m.kfs[0].tcw
    return m, (R12.astype(np.float32), t12.astype(np.float32), 1.0, {}, 0, [])


def test_loop_correct_is_byte_identical_on_the_card(cuda):
    from types import SimpleNamespace

    from airdos_tpu_torch.config import SlamConfig
    from airdos_tpu_torch.io.synthetic import small_camera
    from airdos_tpu_torch.slam.loop_closing import LoopCloser
    cfg = SlamConfig()
    cfg.camera = small_camera()
    ext = SimpleNamespace(scales=tuple(1.2 ** i for i in range(4)),
                          sigma2=np.asarray([1.2 ** (2 * i) for i in range(4)],
                                            np.float32))
    db = SimpleNamespace(voc=SimpleNamespace(score=lambda a, b: 0.0),
                         ensure_bow=lambda kf: None, add=lambda kf: None)
    out = []
    for _ in range(2):
        m, res = _drifted_circle_map()
        assert LoopCloser(cfg, m, db, ext, cuda).correct(m.kfs[23], res)
        out.append(b"".join(k.Rcw.tobytes() + k.tcw.tobytes()
                            for k in m.kfs.values()) +
                   m.points.pos[:m.points.n].tobytes())
    assert out[0] == out[1]
    m, res = _drifted_circle_map()
    LoopCloser(cfg, m, db, ext, "cpu").correct(m.kfs[23], res)
    got = np.frombuffer(out[0][:24 * 48], np.float32)
    want = np.frombuffer(b"".join(k.Rcw.tobytes() + k.tcw.tobytes()
                                  for k in m.kfs.values()), np.float32)
    np.testing.assert_allclose(got, want, atol=1e-4)


def _online_config():
    """tests/test_system_e2e.py's small_config, online."""
    from airdos_tpu_torch.config import SlamConfig
    from airdos_tpu_torch.io.synthetic import small_camera
    cfg = SlamConfig()
    cfg.camera = small_camera()
    cfg.orb.n_features = 600
    cfg.orb.n_levels = 4
    cfg.device.max_keypoints = 1024
    cfg.device.max_local_kfs = 8
    cfg.device.max_fixed_kfs = 4
    cfg.device.max_local_points = 1024
    cfg.device.max_ba_edges = 4096
    cfg.system.is_offline = False
    return cfg


def _vo_frames(n):
    from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
    world = SyntheticStereoWorld(seed=0, n_points=200,
                                 cam=_online_config().camera)
    return [d for d, _, _ in world.sequence(n, dt=0.1, yaw_rate=0.008)]


def test_online_threads_launch_on_their_streams(cuda):
    """Online, tracking's 2-D Hamming launches go to the tracking thread's
    high-priority stream, the mapping worker's batched Hamming and
    segment sums to its own stream of lower priority."""
    import airdos_tpu_torch.ops.segment_kernels as sk
    from airdos_tpu_torch.slam.system import System
    from airdos_tpu_torch.utils.gate import TRACKING_PRIORITY
    frames = _vo_frames(10)
    hk.reset_launches()
    sk.reset_launches()
    slam = System(_online_config(), device=cuda)
    for i, data in enumerate(frames):
        if i + 1 < len(frames):
            slam.prefetch(frames[i + 1])
        slam.track_stereo(data)
    slam.shutdown()
    assert slam.tracking.state.name == "OK"
    tally = {**hk.launch_tally(), **sk.launch_tally()}
    track = {p for (k, th, p) in tally
             if th == "MainThread" and k == "hamming_matrix"}
    mapping = {k: p for (k, th, p) in tally if th == "mapping"
               and k in ("hamming_matrix_batched", "segment_sum")}
    assert track == {slam._track_stream.priority}
    assert slam._track_stream.priority <= TRACKING_PRIORITY
    assert set(mapping) == {"hamming_matrix_batched", "segment_sum"}
    assert min(mapping.values()) > max(track)


def test_prefetched_upload_is_bit_equal_on_the_card(cuda):
    from airdos_tpu_torch.slam.frame import FrontEnd
    data = _vo_frames(4)[3]
    fe = FrontEnd(_online_config(), device=cuda)
    side = torch.cuda.Stream(priority=-1)
    with torch.cuda.stream(side):
        plain = fe.build_frame(data)
        fe.prefetch(data)
        up, done = fe._prefetched[data.index]
        assert isinstance(done, torch.cuda.Event)
        assert all(t.is_cuda for t in up if t is not None)
        pre = fe.build_frame(data)
    torch.cuda.synchronize()
    assert fe._prefetched == {}
    for k in ("xy", "desc32", "octave", "valid", "u_right", "depth"):
        np.testing.assert_array_equal(getattr(pre, k), getattr(plain, k))


# tests/test_examples_cli.py's settings (that module imports airdos_tpu)
_KITTI_YAML = """%YAML:1.0
Camera.fx: 320.0
Camera.fy: 320.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 320
Camera.height: 240
Camera.fps: 5.0
Camera.bf: 80.0
Camera.RGB: 1
ThDepth: 30
ORBextractor.nFeatures: 600
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 12
ORBextractor.minThFAST: 7
System.IsOffline: 1
System.IsMask: 0
Human.OK: 0
Device.MaxKeypoints: 1024
Device.MaxLocalKFs: 8
Device.MaxFixedKFs: 4
Device.MaxLocalPoints: 1024
Device.MaxBAEdges: 4096
"""


def test_kitti_driver_on_the_card_equals_the_in_memory_system(cuda, tmp_path):
    """python -m airdos_tpu_torch.examples.stereo_kitti's main on the card
    (its default device) over 8 PNG frames in the KITTI layout: its KITTI
    file is byte-identical to an in-memory System fed the same uint8
    frames as float32."""
    import dataclasses

    from airdos_tpu_torch.config import SlamConfig
    from airdos_tpu_torch.examples import stereo_kitti
    from airdos_tpu_torch.io.png import imwrite
    from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld, small_camera
    from airdos_tpu_torch.ops import hamming_kernels as hk
    from airdos_tpu_torch.slam.system import System

    world = SyntheticStereoWorld(seed=0, n_points=200, cam=small_camera())
    seq = tmp_path / "seq"
    frames = []
    for i, (d, _, _) in enumerate(world.sequence(8, dt=0.1)):
        left = np.clip(np.rint(d.image_left), 0, 255).astype(np.uint8)
        right = np.clip(np.rint(d.image_right), 0, 255).astype(np.uint8)
        for side, img in (("image_0", left), ("image_1", right)):
            (seq / side).mkdir(parents=True, exist_ok=True)
            imwrite(seq / side / f"{i:06d}.png", img)
        # the timestamp as times.txt gives it back
        frames.append(dataclasses.replace(
            d, timestamp=float(f"{d.timestamp:.6f}"),
            image_left=left.astype(np.float32),
            image_right=right.astype(np.float32)))
    (seq / "times.txt").write_text(
        "".join(f"{d.timestamp:.6f}\n" for d in frames))
    yaml = tmp_path / "settings.yaml"
    yaml.write_text(_KITTI_YAML)
    before = hk.launches()
    assert stereo_kitti.main([str(yaml), str(seq),
                              str(tmp_path / "driver.txt")]) == 0
    assert hk.launches() > before
    slam = System(SlamConfig.from_yaml(yaml))
    for d in frames:
        slam.track_stereo(d)
    slam.shutdown()
    slam.save_trajectory_kitti(tmp_path / "memory.txt")
    got = (tmp_path / "driver.txt").read_bytes()
    assert len(got.decode().splitlines()) == 8
    assert got == (tmp_path / "memory.txt").read_bytes()
