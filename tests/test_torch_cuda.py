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


@pytest.mark.parametrize("ranks", ["virtual", "cards"])
def test_sharded_local_ba_on_the_card(cuda, monkeypatch, ranks):
    """The local BA sharded over 4 virtual ranks of the card, or over
    every card (up to 4) where there are two or more, each rank on its
    own stream: within tests/test_sharded_ba.py's tolerances of the
    single-device solve (R 2e-4, t 2e-3 m, inlier agreement > 0.98), 45
    segment_sum launches by each rank's thread a run, two runs
    bit-equal."""
    import airdos_tpu_torch.ops.segment_kernels as sk
    from airdos_tpu_torch.parallel import mesh as pmesh
    from airdos_tpu_torch.parallel.sharded_ba import (
        make_mesh, sharded_local_bundle_adjust)
    from airdos_tpu_torch.solvers.local_ba import local_bundle_adjust
    n = 4 if ranks == "virtual" else min(4, torch.cuda.device_count())
    if n < 2:
        pytest.skip("needs two or more cards")
    if ranks == "virtual":
        monkeypatch.setenv(pmesh.VIRTUAL_DEVICES_ENV, "4")
    else:
        monkeypatch.delenv(pmesh.VIRTUAL_DEVICES_ENV, raising=False)
    arrays = list(_gba_corridor(np.random.default_rng(1), C=12, P=600,
                                per_cam=80))
    pad = -len(arrays[5]) % n
    fill = (0, 0, -1.0, 0.0, False)
    for i, f in zip(range(5, 10), fill):
        arrays[i] = np.concatenate(
            [arrays[i], np.full((pad,) + arrays[i].shape[1:], f,
                                arrays[i].dtype)])
    dev = [torch.from_numpy(a).to(cuda) for a in arrays]
    intr = (300.0, 300.0, 160.0, 120.0, 60.0)
    single = local_bundle_adjust(*dev, *intr)
    mesh = make_mesh(n, cuda)
    assert mesh.virtual == (ranks == "virtual") and mesh.size == n
    run = sharded_local_bundle_adjust(mesh)
    sk.reset_launches()
    res1 = run(*dev, *intr)
    res2 = run(*dev, *intr)
    torch.cuda.synchronize()
    assert sk.launches() == 2 * n * 45
    by_thread = {}
    for (_, thread, _), k in sk.launch_tally().items():
        by_thread[thread] = by_thread.get(thread, 0) + k
    assert sorted(by_thread.values()) == [90] * n, by_thread
    for a, b in zip(res1, res2):
        assert torch.equal(a, b)
    assert (res1.R - single.R).abs().max() < 2e-4
    assert (res1.t - single.t).abs().max() < 2e-3
    assert (res1.edge_inlier == single.edge_inlier).float().mean() > 0.98
    assert (res1.t - dev[1]).abs().max() > 1e-3        # the solve moved


def test_global_ba_segment_sums_bitwise_and_deterministic(cuda, monkeypatch):
    """Every segment sum of a global BA step on the card, at its camera-
    and point-keyed shapes (42, 12, 42, 3 columns), bit-equal to the
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
    assert len(seen) == 2 * gba.launches_per_step(48)["segment_sum"]
    assert {k for (_, k), _ in seen} == {42, 12, 3}
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
    """Online, tracking's matcher launches (match_rows) go to the tracking
    thread's high-priority stream, the mapping worker's fusion (match_rows
    in fuse mode) and segment sums to its own stream of lower priority."""
    import airdos_tpu_torch.ops.match_kernels as mk
    import airdos_tpu_torch.ops.segment_kernels as sk
    from airdos_tpu_torch.slam.system import System
    from airdos_tpu_torch.utils.gate import TRACKING_PRIORITY
    frames = _vo_frames(10)
    hk.reset_launches()
    sk.reset_launches()
    mk.reset_launches()
    slam = System(_online_config(), device=cuda)
    for i, data in enumerate(frames):
        if i + 1 < len(frames):
            slam.prefetch(frames[i + 1])
        slam.track_stereo(data)
    slam.shutdown()
    assert slam.tracking.state.name == "OK"
    tally = {**hk.launch_tally(), **sk.launch_tally(), **mk.launch_tally()}
    track = {p for (k, th, p) in tally
             if th == "MainThread" and k == "match_rows"}
    mapping = {k: p for (k, th, p) in tally if th == "mapping"
               and k in ("match_fuse", "segment_sum")}
    assert track == {slam._track_stream.priority}
    assert slam._track_stream.priority <= TRACKING_PRIORITY
    assert set(mapping) == {"match_fuse", "segment_sum"}
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
    from airdos_tpu_torch.ops import match_kernels as mk
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
    before = mk.launches()
    assert stereo_kitti.main([str(yaml), str(seq),
                              str(tmp_path / "driver.txt")]) == 0
    assert mk.launches() > before
    slam = System(SlamConfig.from_yaml(yaml))
    for d in frames:
        slam.track_stereo(d)
    slam.shutdown()
    slam.save_trajectory_kitti(tmp_path / "memory.txt")
    got = (tmp_path / "driver.txt").read_bytes()
    assert len(got.decode().splitlines()) == 8
    assert got == (tmp_path / "memory.txt").read_bytes()


# ------------------------------------ the tracking frame's three kernels

def _texture(rng, h, w):
    """Uniform noise under two 5x5 box blurs, quantized to 0..255."""
    img = rng.uniform(0, 255, (h + 8, w + 8))
    for _ in range(2):
        img = sum(img[dy:dy + img.shape[0] - 4, dx:dx + img.shape[1] - 4]
                  for dy in range(5) for dx in range(5)) / 25.0
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    return np.round(img).astype(np.float32)


def _pose_case(rng, n, n_mono, invalid, prior):
    import airdos_tpu_torch.solvers.pose_opt as po
    from airdos_tpu_torch.geometry.se3 import se3_exp_np
    fx = fy = 500.0
    cx, cy, bf = 320.0, 180.0, 250.0
    xw = rng.uniform([-5, -3, 4], [5, 3, 25], (n, 3))
    Rgt, tgt = se3_exp_np(np.array([0.1, -0.05, 0.2, 0.02, -0.03, 0.01]))
    xc = xw @ Rgt.T + tgt
    u = fx * xc[:, 0] / xc[:, 2] + cx
    v = fy * xc[:, 1] / xc[:, 2] + cy
    obs = np.stack([u, v, u - bf / xc[:, 2]], axis=1)
    obs[:, :2] += rng.normal(0, 0.3, (n, 2))
    out = rng.choice(n, n // 10, replace=False)
    obs[out, :2] += rng.uniform(20, 60, (len(out), 2))
    obs[:n_mono, 2] = -1.0
    R0, t0 = se3_exp_np(np.array([0.15, 0.0, 0.12, 0.03, -0.01, -0.005]))
    isig = 1.0 / 1.2 ** (2 * rng.integers(0, 4, n))
    valid = rng.uniform(size=n) >= invalid
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    return po.pack_problem(f(R0), f(t0), f(xw), f(obs), f(isig),
                           torch.as_tensor(valid), fx, fy, cx, cy, bf,
                           2.447749, 2.795483, prior, prior)


@pytest.mark.parametrize("n,n_mono,invalid,prior", [
    (2048, 200, 0.1, 400.0), (1536, 0, 0.05, 0.0), (777, 777, 0.05, 400.0),
    (20, 0, 0.0, 0.0), (300, 30, 1.0, 400.0), (0, 0, 0.0, 400.0),
    # the edges of the cluster's ranges: N not a multiple of its blocks'
    # threads, one edge (with the prior: one edge alone leaves the pose
    # undetermined), the most the wrapper takes, all mono, prior on/off
    (1537, 100, 0.05, 0.0), (1537, 100, 0.05, 400.0), (1, 0, 0.0, 400.0),
    (1, 1, 0.0, 400.0), (40960, 4000, 0.05, 0.0), (40960, 0, 0.05, 400.0),
    (2048, 2048, 0.05, 0.0)])
def test_pose_lm_kernel_within_tolerance_of_plain_version(cuda, n, n_mono,
                                                          invalid, prior):
    import airdos_tpu_torch.solvers.pose_opt as po
    rng = np.random.default_rng(n + n_mono)
    prob = _pose_case(rng, n, n_mono, invalid, prior)
    args = (prob.pose0.to(cuda), prob.edges.to(cuda), prob.scalars)
    before = po.launches()
    got = po.pose_lm_cuda(*args)
    again = po.pose_lm_cuda(*args)
    want = po.pose_lm_ref(*args)
    torch.cuda.synchronize()
    assert po.launches() == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert float(torch.linalg.norm(got.R - want.R)) <= 1e-4
    assert float((got.t - want.t).abs().max()) <= 1e-4
    if n:
        assert float((got.inlier == want.inlier).float().mean()) >= 0.99
    assert int(got.n_inliers) == int(got.inlier.sum())
    cpu = po.pose_lm_ref(prob.pose0, prob.edges, prob.scalars)
    assert float(torch.linalg.norm(got.R.cpu() - cpu.R)) <= 1e-4


def test_pose_optimize_launches_once_on_the_card(cuda):
    import airdos_tpu_torch.solvers.pose_opt as po
    rng = np.random.default_rng(3)
    prob = _pose_case(rng, 500, 50, 0.05, 0.0)
    e = prob.edges.to(cuda)
    R0 = prob.pose0[:9].reshape(3, 3).to(cuda)
    before = po.launches()
    res = po.pose_optimize(R0, prob.pose0[9:].to(cuda), e[:, :3], e[:, 3:6],
                           e[:, 6], e[:, 7] > 0, *prob.scalars[:5])
    torch.cuda.synchronize()
    assert po.launches() == before + 1
    assert res.R.is_cuda and res.inlier.shape == (500,)


def test_pose_lm_kernel_rejects_what_it_does_not_take(cuda):
    import airdos_tpu_torch.solvers.pose_opt as po
    prob = _pose_case(np.random.default_rng(4), 64, 0, 0.0, 0.0)
    pose0, edges = prob.pose0.to(cuda), prob.edges.to(cuda)
    for bad in (edges.double(), edges[:, :7].contiguous(),
                edges.t().contiguous().t(), prob.edges):
        with pytest.raises(ValueError):
            po.pose_lm_cuda(pose0, bad, prob.scalars)
    with pytest.raises(ValueError):
        po.pose_lm_cuda(prob.pose0, edges, prob.scalars)
    with pytest.raises(ValueError):
        po.pose_lm_cuda(pose0[:9], edges, prob.scalars)


@pytest.mark.parametrize("h,w,masked", [(360, 640, False), (300, 533, True),
                                        (100, 179, True), (40, 40, False),
                                        (20, 50, False)])
def test_fast_nms_kernel_equals_plain_version(cuda, h, w, masked):
    import airdos_tpu_torch.ops.fast as fk
    rng = np.random.default_rng(h * w)
    img = torch.from_numpy(_texture(rng, h, w)).to(cuda)
    mask = torch.ones_like(img)
    if masked:
        mask[h // 4:h // 2, w // 3:w // 2] = 0.0
    before = fk.launches()
    got = fk.fast_nms(img, mask, 7.0, 16)
    again = fk.fast_nms(img, mask, 7.0, 16)
    torch.cuda.synchronize()
    assert fk.launches() == before + 2
    assert torch.equal(got, fk.fast_nms_ref(img, mask, 7.0, 16))
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), fk.fast_nms_ref(img.cpu(), mask.cpu(),
                                                  7.0, 16))


def test_fast_nms_kernel_rejects_what_it_does_not_take(cuda):
    import airdos_tpu_torch.ops.fast as fk
    img = torch.zeros((64, 96), device=cuda)
    for bad in (img.double(), img[None], img.t(), img.cpu()):
        with pytest.raises(ValueError):
            fk.fast_nms_cuda(bad, bad, 7.0, 16)
    with pytest.raises(ValueError):
        fk.fast_nms_cuda(img, img[:32].contiguous(), 7.0, 16)
    with pytest.raises(ValueError):
        fk.fast_nms_cuda(img, img, 7.0, 2)


@pytest.mark.parametrize("h,w,n,scale", [(360, 640, 326, 1.0),
                                         (208, 370, 189, 1.2),
                                         (100, 179, 91, 1.0)])
def test_orb_desc_kernel_equals_plain_version(cuda, h, w, n, scale):
    import airdos_tpu_torch.ops.orb_kernels as ok
    from airdos_tpu_torch.ops.filters import gaussian_blur7, resize_bilinear
    rng = np.random.default_rng(n)
    img = torch.from_numpy(_texture(rng, h, w)).to(cuda)
    if scale != 1.0:      # an interpolated level: fractional pixels
        img = resize_bilinear(img, int(h / scale), int(w / scale))
        h, w = img.shape
    blur = gaussian_blur7(img)
    xs = torch.from_numpy(rng.integers(16, w - 16, n)).to(cuda)
    ys = torch.from_numpy(rng.integers(16, h - 16, n)).to(cuda)
    xs[:3] = 0                  # padded slots at the corner
    ys[:3] = 0
    before = ok.launches()
    ang, words = ok.orb_describe(img, blur, xs, ys)
    ang2, words2 = ok.orb_describe(img, blur, xs, ys)
    want_ang, want_words = ok.orb_describe_ref(img, blur, xs, ys)
    torch.cuda.synchronize()
    assert ok.launches() == before + 2
    assert torch.equal(ang, ang2) and torch.equal(words, words2)
    assert torch.equal(ang, want_ang)
    assert torch.equal(words, want_words)


def _faint_pixels(rng, h, w):
    """An 8-bit texture in which every other pixel, at random, is scaled
    to 1e-9..1e-6 with a full float32 mantissa: the nonzero pixels under
    2^-8 that a bilinear level can hold beside zero pixels, here beside
    bright ones, so that a disc's float64 moment sums cannot be exact."""
    img = _texture(rng, h, w) + 1.0
    faint = rng.uniform(size=(h, w)) < 0.5
    img[faint] *= (10.0 ** rng.uniform(-9, -6, int(faint.sum()))) \
        .astype(np.float32)
    return img


def test_orb_desc_kernel_equals_plain_version_on_pixels_under_2e_8(cuda):
    """Discs that hold nonzero pixels under 2^-8 beside bright ones: the
    float64 moment sums round, each version in its own order
    (ops/orb_kernels.py), and the rounded float32 moments, the angles and
    the words still come out bit-equal."""
    import airdos_tpu_torch.ops.orb_kernels as ok
    from airdos_tpu_torch.ops.filters import gaussian_blur7
    rng = np.random.default_rng(7)
    h, w, n = 208, 370, 300
    img = torch.from_numpy(_faint_pixels(rng, h, w)).to(cuda)
    blur = gaussian_blur7(img)
    xs = torch.from_numpy(rng.integers(16, w - 16, n)).to(cuda)
    ys = torch.from_numpy(rng.integers(16, h - 16, n)).to(cuda)
    ang, words = ok.orb_describe(img, blur, xs, ys)
    want_ang, want_words = ok.orb_describe_ref(img, blur, xs, ys)
    torch.cuda.synchronize()
    n_ang = int((ang.view(torch.int32) != want_ang.view(torch.int32)).sum())
    n_desc = int((words != want_words).any(dim=1).sum())
    assert (n_ang, n_desc) == (0, 0), (n_ang, n_desc)


def test_orb_desc_kernel_rejects_what_it_does_not_take(cuda):
    import airdos_tpu_torch.ops.orb_kernels as ok
    img = torch.zeros((64, 96), device=cuda)
    xs = torch.zeros(8, dtype=torch.int64, device=cuda)
    for args in ((img.double(), img, xs, xs), (img.t(), img, xs, xs),
                 (img, img[:32].contiguous(), xs, xs),
                 (img, img, xs.to(torch.int32), xs),
                 (img, img, xs, xs[:4]), (img.cpu(), img.cpu(), xs, xs),
                 (img, img, xs.cpu(), xs)):
        with pytest.raises(ValueError):
            ok.orb_describe_cuda(*args)



def _orb_levels_case(rng, h, w, n_levels, n_features):
    """An image's pyramid levels and blurs (the port's kernels) and the
    selected keypoints of every level at the extractor's quotas."""
    import airdos_tpu_torch.ops.fast as fk
    import airdos_tpu_torch.ops.pyramid as pk
    import airdos_tpu_torch.ops.select as sk
    from airdos_tpu_torch.features.orb import (MIN_BORDER, _cell_size_for,
                                               level_quotas)
    pyr = pk.build_pyramid(torch.from_numpy(_texture(rng, h, w)).cuda(),
                           None, n_levels, 1.2)
    maps = [fk.fast_nms(im, m, 7.0, MIN_BORDER)
            for im, m in zip(pyr.images, pyr.masks)]
    quotas = level_quotas(n_features, n_levels, 1.2)
    cells = [_cell_size_for(s.shape[0] - 2 * MIN_BORDER,
                            s.shape[1] - 2 * MIN_BORDER, q)
             for s, q in zip(maps, quotas)]
    xs, ys, _ = sk.select_keypoints(maps, quotas, cells, 12.0)
    return list(pyr.images), list(pyr.blurred), xs, ys, list(quotas)


@pytest.mark.parametrize("h,w,n_levels,n_features", [(360, 640, 8, 1500),
                                                     (240, 320, 4, 600)])
def test_orb_desc_levels_kernel_equals_plain_version(cuda, h, w, n_levels,
                                                     n_features):
    """All levels in one launch: bit-equal to the plain version, to the
    per-level launches of the same kernel and to itself."""
    import airdos_tpu_torch.ops.orb_kernels as ok
    rng = np.random.default_rng(h + n_levels)
    images, blurred, xs, ys, quotas = _orb_levels_case(rng, h, w, n_levels,
                                                       n_features)
    before = ok.launches()
    ang, words = ok.orb_describe_levels(images, blurred, xs, ys, quotas)
    ang2, words2 = ok.orb_describe_levels(images, blurred, xs, ys, quotas)
    torch.cuda.synchronize()
    assert ok.launches() == before + 2
    assert torch.equal(ang, ang2) and torch.equal(words, words2)
    per = [ok.orb_describe_cuda(im, bl, xs[f:f + q], ys[f:f + q])
           for im, bl, f, q in zip(images, blurred, ok.level_table(quotas),
                                   quotas)]
    assert torch.equal(ang, torch.cat([a for a, _ in per]))
    assert torch.equal(words, torch.cat([d for _, d in per]))
    want_ang, want_words = ok.orb_describe_levels_ref(images, blurred, xs,
                                                      ys, quotas)
    torch.cuda.synchronize()
    assert torch.equal(ang, want_ang)
    assert torch.equal(words, want_words)


def test_orb_desc_levels_kernel_takes_levels_with_no_keypoints(cuda):
    import airdos_tpu_torch.ops.orb_kernels as ok
    rng = np.random.default_rng(17)
    images, blurred, xs, ys, _ = _orb_levels_case(rng, 240, 320, 4, 600)
    quotas = [50, 0, 30, 0]
    xs, ys = xs[:80].contiguous(), ys[:80].contiguous()
    got = ok.orb_describe_levels(images, blurred, xs, ys, quotas)
    want = ok.orb_describe_levels_ref(images, blurred, xs, ys, quotas)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    before = ok.launches()
    ang, words = ok.orb_describe_levels(images, blurred, xs[:0], ys[:0],
                                        [0, 0, 0, 0])
    assert ok.launches() == before            # no slot: no launch
    assert ang.shape == (0,) and words.shape == (0, 8)


def test_orb_desc_levels_kernel_rejects_what_it_does_not_take(cuda):
    import airdos_tpu_torch.ops.orb_kernels as ok
    img = torch.zeros((64, 96), device=cuda)
    xs = torch.zeros(8, dtype=torch.int64, device=cuda)
    for args in (([img] * 17, [img] * 17, xs, xs, [0] * 16 + [8]),
                 ([img] * 2, [img], xs, xs, [4, 4]),
                 ([img] * 2, [img] * 2, xs, xs, [4, 3]),
                 ([img, img.double()], [img] * 2, xs, xs, [4, 4]),
                 ([img, img], [img, img[:32].contiguous()], xs, xs, [4, 4]),
                 ([img] * 2, [img] * 2, xs.to(torch.int32), xs, [4, 4]),
                 ([img] * 2, [img] * 2, xs, xs.cpu(), [4, 4]),
                 ([img] * 2, [img] * 2, xs, xs, [12, -4])):
        with pytest.raises(ValueError):
            ok.orb_describe_levels_cuda(*args)

# ------------------------------------------- the front end's four kernels

def _pyramid_inputs(rng, h, w, mask_kind):
    img = _texture(rng, h, w)
    mask = None
    if mask_kind is not None:
        mask = np.ones((h, w), np.uint8)
        mask[h // 4:h // 2, w // 3:w // 2] = 0
        mask[: h // 8, -w // 6:] = 0
        if mask_kind == "float32":
            mask = mask.astype(np.float32)
    return img, mask


@pytest.mark.parametrize("h,w,n_levels,mask_kind", [
    (360, 640, 8, "uint8"), (360, 640, 8, None), (240, 320, 4, "float32"),
    (101, 179, 3, "uint8"), (35, 38, 2, None)])
def test_pyramid_kernel_equals_plain_version(cuda, h, w, n_levels, mask_kind):
    """Images, masks and blurs bit-equal to the plain version on the card
    and on the CPU and to the one-level kernel's launches, in one launch
    an image; odd sizes and a level at most twice the FAST border among
    them."""
    import airdos_tpu_torch.ops.pyramid as pk
    rng = np.random.default_rng(h + w)
    img, mask = _pyramid_inputs(rng, h, w, mask_kind)
    img_d = torch.from_numpy(img).to(cuda)
    mask_d = None if mask is None else torch.from_numpy(mask).to(cuda)
    before = pk.launches()
    got = pk.build_pyramid(img_d, mask_d, n_levels, 1.2)
    torch.cuda.synchronize()
    assert pk.launches() == before + 1
    _assert_pyramid_is_the_level_launches(got, img_d, mask_d, 10)
    want = pk.build_pyramid(img_d, mask_d, n_levels, 1.2)
    want_cpu = pk.build_pyramid(img_d.cpu(),
                                None if mask_d is None else mask_d.cpu(),
                                n_levels, 1.2)
    for lvl in range(n_levels):
        plain = pk.pyramid_level_ref(
            *((img_d, mask_d, h, w, True) if lvl == 0 else
              (got.images[lvl - 1], got.masks[lvl - 1],
               *got.images[lvl].shape, False)))
        for name, a, b, c in zip(("image", "mask", "blur"),
                                 (got.images[lvl], got.masks[lvl],
                                  got.blurred[lvl]), plain,
                                 (want_cpu.images[lvl], want_cpu.masks[lvl],
                                  want_cpu.blurred[lvl])):
            assert torch.equal(a, b), (lvl, name)
            assert torch.equal(a.cpu(), c), (lvl, name)
    assert all(torch.equal(a, b) for a, b in zip(got.blurred, want.blurred))


def test_pyramid_kernel_rejects_what_it_does_not_take(cuda):
    import airdos_tpu_torch.ops.pyramid as pk
    img = torch.zeros((64, 96), device=cuda)
    for args in ((img.double(), None, 64, 96, True),
                 (img.t(), None, 96, 64, True),
                 (img.cpu(), None, 64, 96, True),
                 (img, None, 32, 48, True),
                 (img, img.to(torch.int32), 64, 96, True),
                 (img, None, 53, 80, False),
                 (img, img[:32].contiguous(), 53, 80, False),
                 (img, img, 3, 80, False)):
        with pytest.raises(ValueError):
            pk.pyramid_level_cuda(*args)


def _assert_pyramid_is_the_level_launches(pyr, img, mask, erode_k):
    """pyr (one launch) equals the one-level kernel's launches, each level
    from the one before, bit for bit."""
    import airdos_tpu_torch.ops.pyramid as pk
    prev = pk.pyramid_level_cuda(img, mask, *img.shape, True, erode_k)
    for lvl in range(len(pyr.images)):
        if lvl:
            prev = pk.pyramid_level_cuda(prev[0], prev[1],
                                         *pyr.images[lvl].shape, False)
        torch.cuda.synchronize()
        for name, a, b in zip(("image", "mask", "blur"), prev,
                              (pyr.images[lvl], pyr.masks[lvl],
                               pyr.blurred[lvl])):
            assert torch.equal(a, b), (lvl, name)


@pytest.mark.parametrize("h,w,n_levels,mask_kind", [
    (360, 640, 8, None), (360, 640, 8, "uint8"), (360, 640, 8, "float32"),
    (240, 320, 4, "uint8"), (120, 160, 4, None), (44, 60, 3, "uint8"),
    (400, 700, 16, None)])
def test_pyramid_levels_launch_is_the_per_level_launches(cuda, h, w,
                                                         n_levels, mask_kind):
    """One cooperative launch an image at the paths' shapes (and 16
    levels, and levels under a tile a side): bit-equal to the per-level
    launches and to the plain version, two launches bit-equal, views into
    one buffer."""
    import airdos_tpu_torch.ops.pyramid as pk
    rng = np.random.default_rng(h * 3 + w + n_levels)
    img, mask = _pyramid_inputs(rng, h, w, mask_kind)
    img_d = torch.from_numpy(img).to(cuda)
    mask_d = None if mask is None else torch.from_numpy(mask).to(cuda)
    before = pk.launches()
    got = pk.build_pyramid_cuda(img_d, mask_d, n_levels, 1.2)
    again = pk.build_pyramid_cuda(img_d, mask_d, n_levels, 1.2)
    torch.cuda.synchronize()
    assert pk.launches() == before + 2
    assert got.images[0] is img_d
    base = got.masks[0].untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() == base
               for x in got.images[1:] + got.masks + got.blurred)
    for part in range(3):
        assert all(torch.equal(a, b) for a, b in zip(got[part], again[part]))
    _assert_pyramid_is_the_level_launches(got, img_d, mask_d, 10)
    want = pk.build_pyramid(img_d.cpu(), None if mask_d is None
                            else mask_d.cpu(), n_levels, 1.2)
    for part in range(3):
        assert all(torch.equal(a.cpu(), b)
                   for a, b in zip(got[part], want[part]))
    shapes = pk.level_shapes(h, w, n_levels, 1.2)
    cooperative, sms, per_sm = pk.residency(img_d.device)
    assert cooperative == 1 and per_sm >= 1
    assert pk.cooperative_grid(img_d.device, shapes) <= sms * per_sm


def test_pyramid_levels_launch_on_a_high_priority_stream(cuda):
    """Tracking's stream (priority -1) beside a busy stream of priority 0:
    the cooperative launch gives what it gives on the default stream."""
    import airdos_tpu_torch.ops.pyramid as pk
    rng = np.random.default_rng(7)
    img, mask = _pyramid_inputs(rng, 360, 640, "uint8")
    img_d = torch.from_numpy(img).to(cuda)
    mask_d = torch.from_numpy(mask).to(cuda)
    want = pk.build_pyramid_cuda(img_d, mask_d, 8, 1.2)
    torch.cuda.synchronize()
    busy = torch.cuda.Stream(priority=0)
    side = torch.cuda.Stream(priority=-1)
    a = torch.randn(4096, 4096, device=cuda)
    with torch.cuda.stream(busy):
        for _ in range(4):
            a = a @ a.T / 4096.0
    with torch.cuda.stream(side):
        got = [pk.build_pyramid_cuda(img_d, mask_d, 8, 1.2)
               for _ in range(4)]
    torch.cuda.synchronize()
    for pyr in got:
        for part in range(3):
            assert all(torch.equal(x, y) for x, y in zip(pyr[part],
                                                         want[part]))


def test_pyramid_levels_launch_rejects_what_it_does_not_take(cuda):
    import airdos_tpu_torch.ops.pyramid as pk
    img = torch.zeros((64, 96), device=cuda)
    for args in ((img.double(), None, 3), (img.cpu(), None, 3),
                 (img, img.to(torch.int32), 3), (img, img[:32], 3),
                 (img, None, 17), (img, None, 0),
                 (img[:20].contiguous(), None, 12)):
        with pytest.raises(ValueError):
            pk.build_pyramid_cuda(*args)
    with pytest.raises(ValueError):
        pk.build_pyramid_cuda(img, None, 3, 1.2, mask_erode=17)


@pytest.mark.parametrize("h,w,n_levels,masked", [
    (360, 640, 8, False), (360, 640, 8, True), (240, 320, 4, True),
    (120, 160, 4, False), (44, 60, 3, True), (400, 700, 16, False)])
def test_fast_nms_levels_launch_is_the_per_level_launches(cuda, h, w,
                                                          n_levels, masked):
    """One launch an image over its levels at the paths' shapes (and 16
    levels, and levels under a tile a side): bit-equal to the per-level
    launches and to the plain version, two launches bit-equal, the maps
    views into one buffer."""
    import airdos_tpu_torch.ops.fast as fk
    import airdos_tpu_torch.ops.pyramid as pk
    rng = np.random.default_rng(h + 5 * w + n_levels)
    img, mask = _pyramid_inputs(rng, h, w, "uint8" if masked else None)
    pyr = pk.build_pyramid(
        torch.from_numpy(img).to(cuda),
        None if mask is None else torch.from_numpy(mask).to(cuda),
        n_levels, 1.2)
    before = fk.launches()
    got = fk.fast_nms_levels(pyr.images, pyr.masks, 7.0, 16)
    again = fk.fast_nms_levels(pyr.images, pyr.masks, 7.0, 16)
    torch.cuda.synchronize()
    assert fk.launches() == before + 2
    base = got[0].untyped_storage().data_ptr()
    assert all(m.untyped_storage().data_ptr() == base for m in got)
    per = [fk.fast_nms(im, m, 7.0, 16) for im, m in zip(pyr.images,
                                                        pyr.masks)]
    want = fk.fast_nms_levels_ref(pyr.images, pyr.masks, 7.0, 16)
    torch.cuda.synchronize()
    for a, b, c, d in zip(got, again, per, want):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
    assert sum(int((m > 0).sum()) for m in got) > 0


def test_fast_nms_levels_launch_rejects_what_it_does_not_take(cuda):
    import airdos_tpu_torch.ops.fast as fk
    img = torch.zeros((64, 96), device=cuda)
    for args in (([img] * 17, [img] * 17, 7.0, 16),
                 ([img] * 2, [img], 7.0, 16),
                 ([img, img.double()], [img] * 2, 7.0, 16),
                 ([img, img], [img, img[:32].contiguous()], 7.0, 16),
                 ([img.cpu()] * 2, [img.cpu()] * 2, 7.0, 16),
                 ([img] * 2, [img] * 2, 7.0, 2)):
        with pytest.raises(ValueError):
            fk.fast_nms_levels_cuda(*args)


def _detection_maps(rng, h, w, n_levels, masked):
    import airdos_tpu_torch.ops.fast as fk
    import airdos_tpu_torch.ops.pyramid as pk
    img, mask = _pyramid_inputs(rng, h, w, "uint8" if masked else None)
    pyr = pk.build_pyramid(
        torch.from_numpy(img).cuda(),
        None if mask is None else torch.from_numpy(mask).cuda(),
        n_levels, 1.2)
    return [fk.fast_nms(im, m, 7.0, 16) for im, m in zip(pyr.images,
                                                          pyr.masks)]


def _select_case(rng, case):
    from airdos_tpu_torch.features.orb import (MIN_BORDER, _cell_size_for,
                                               level_quotas)
    if case in ("few cells", "quota 0", "largest"):
        # fewer cells than the cluster has blocks; a level with quota 0
        # between two that have one; the most cells the shared-memory
        # check admits (12672 of 8 px)
        shapes, quotas, cells = {
            "few cells": (((16, 24), (9, 40), (20, 20)), (4, 10, 3),
                          (8, 8, 8)),
            "quota 0": (((120, 160), (100, 133), (83, 111)), (80, 0, 30),
                        (8, 9, 8)),
            "largest": (((768, 1056),), (3000,), (8,))}[case]
        maps = [torch.from_numpy(
            (rng.uniform(0, 60, (h, w)) * (rng.uniform(size=(h, w)) < 0.1))
            .astype(np.float32)).cuda() for h, w in shapes]
        return maps, quotas, list(cells)
    if case == "ties":
        # quantized maps: equal responses inside cells and across blocks
        maps = [torch.from_numpy(
            (rng.integers(0, 4, (h, w)) * 6.0 * (rng.uniform(size=(h, w))
                                                 < 0.05)).astype(np.float32)
        ).cuda() for h, w in ((120, 160), (100, 133), (83, 111))]
        quotas = (150, 90, 400)          # the last more than its cells
    else:
        h, w, n_levels = {"640x360": (360, 640, 8), "odd": (101, 179, 3),
                          "masked": (240, 320, 4)}[case]
        maps = _detection_maps(rng, h, w, n_levels, case == "masked")
        quotas = level_quotas(1500 if case == "640x360" else 300, n_levels,
                              1.2)
    cells = [_cell_size_for(s.shape[0] - 2 * MIN_BORDER,
                            s.shape[1] - 2 * MIN_BORDER, q)
             for s, q in zip(maps, quotas)]
    return maps, quotas, cells


@pytest.mark.parametrize("case", ["640x360", "odd", "masked", "ties",
                                  "few cells", "quota 0", "largest"])
def test_select_kernel_equals_plain_version(cuda, case):
    """xs, ys and responses bit-equal to the plain version, one launch an
    image, on real detection maps and on maps full of ties."""
    import airdos_tpu_torch.ops.select as sk
    maps, quotas, cells = _select_case(np.random.default_rng(5), case)
    before = sk.launches()
    got = sk.select_keypoints(maps, quotas, cells, 12.0)
    again = sk.select_keypoints(maps, quotas, cells, 12.0)
    torch.cuda.synchronize()
    assert sk.launches() == before + 2
    want = sk.select_keypoints_ref(maps, quotas, cells, 12.0)
    want_cpu = sk.select_keypoints_ref([s.cpu() for s in maps], quotas,
                                       cells, 12.0)
    for a, b, c, d in zip(got, again, want, want_cpu):
        assert a.shape == (sum(quotas),)
        assert torch.equal(a, b) and torch.equal(a, c)
        assert torch.equal(a.cpu(), d)
    assert int((got[2] > 0).sum()) > 0


def test_select_kernel_rejects_what_it_does_not_take(cuda):
    import airdos_tpu_torch.ops.select as sk
    s = torch.zeros((64, 96), device=cuda)
    for maps, quotas, cells in (([s.double()], [10], [8]), ([s.t()], [10], [8]),
                                ([s.cpu()], [10], [8]), ([s], [10, 5], [8]),
                                ([s], [-1], [8]), ([s], [10], [0]),
                                ([], [], []), ([s] * 17, [1] * 17, [8] * 17),
                                ([torch.zeros((4000, 4000), device=cuda)],
                                 [10], [8]),
                                # one cell more than the largest admitted
                                ([torch.zeros((8, 8 * 12673), device=cuda)],
                                 [10], [8])):
        with pytest.raises(ValueError):
            sk.select_keypoints_cuda(maps, quotas, cells, 12.0)


def _sad_case(rng, kind):
    """The stereo refinement's inputs: a pyramid pair and, for each left
    keypoint, the right keypoint it matched.  "random": a texture and its
    copy shifted 7 px at the bench budget (360x640, 8 levels, 1536
    keypoints), keypoints anywhere on each level (the edges included),
    random matches and gates; "long-110": the same at long-110's (240x320,
    4 levels, 640 keypoints); "faint": the bench case with the texture
    scaled to [0, 2^-6], so that most pixels are under 2^-8; "synthetic":
    a rendered small-camera frame through the port's front end on the
    card, with the matches and gates stereo_match computes."""
    import airdos_tpu_torch.ops.pyramid as pk
    scales = torch.tensor([1.2 ** l for l in range(8)], dtype=torch.float32,
                          device="cuda")
    if kind == "synthetic":
        import airdos_tpu_torch.matching.stereo as ms
        from airdos_tpu_torch.config import SlamConfig
        from airdos_tpu_torch.io.synthetic import (SyntheticStereoWorld,
                                                   small_camera)
        from airdos_tpu_torch.slam.frame import FrontEnd
        cfg = SlamConfig()
        cfg.camera = small_camera()
        cfg.orb.n_features, cfg.orb.n_levels = 600, 4
        world = SyntheticStereoWorld(seed=0, n_points=200, cam=cfg.camera)
        data = next(iter(world.sequence(1, dt=0.1)))[0]
        fe = FrontEnd(cfg, device="cuda")
        seen = {}
        real = ms.stereo_sad

        def spy(*args):
            seen["args"] = args
            return real(*args)
        ms.stereo_sad = spy
        try:
            fe._build_impl(*fe.uploads(data),
                           torch.zeros((0, 2), device="cuda"), False)
        finally:
            ms.stereo_sad = real
        return seen["args"]
    h, w, n_levels, n = (240, 320, 4, 640) if kind == "long-110" else \
        (360, 640, 8, 1536)
    left = _texture(rng, h, w + 7)
    if kind == "faint":
        left = (left * np.float32(2.0 ** -6 / 255.0)).astype(np.float32)
    pl = pk.build_pyramid(torch.from_numpy(left[:, 7:].copy()).cuda(), None,
                          n_levels, 1.2)
    pr = pk.build_pyramid(torch.from_numpy(left[:, :-7].copy()).cuda(),
                          None, n_levels, 1.2)
    oct_l = rng.integers(0, n_levels, n)
    xy_l = np.stack([rng.uniform(-3, w + 3, n), rng.uniform(-3, h + 3, n)],
                    axis=1).astype(np.float32)
    xy_r = (xy_l - [[7.0 + rng.uniform(-1, 1), 0.0]]).astype(np.float32)
    widths = torch.tensor([im.shape[1] for im in pl.images], device="cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa
    return (t(xy_l), t(oct_l.astype(np.int64)), t(rng.uniform(size=n) < 0.9),
            t(xy_r), t(np.where(rng.uniform(size=n) < 0.8, np.arange(n),
                                rng.integers(0, n, n)).astype(np.int64)),
            t(rng.uniform(size=n) < 0.7), pl.images, pr.images, widths,
            scales[:n_levels], float(np.float32(250.0) / np.float32(0.5)))


@pytest.mark.parametrize("kind", ["random", "long-110", "synthetic"])
def test_stereo_sad_kernel_equals_plain_version(cuda, kind):
    """best_sad, u_right, disparity and the accept flags bit-equal to the
    plain version (every pixel is 0 or >= 1: the module's condition), one
    launch a call."""
    import airdos_tpu_torch.ops.stereo_sad as ss
    args = _sad_case(np.random.default_rng(9), kind)
    before = ss.launches()
    got = ss.stereo_sad(*args)
    again = ss.stereo_sad(*args)
    torch.cuda.synchronize()
    assert ss.launches() == before + 2
    want = ss.stereo_sad_ref(*args)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert int(got[3].sum()) > 20


def test_stereo_sad_kernel_within_limits_on_pixels_under_2e_8(cuda):
    """Where pixels under 2^-8 let the float64 sums round, each order its
    own way: >= 99.9% of accept flags equal and u_right within 1e-3 px
    where both accept (ops/stereo_sad.py's limits); two launches
    bit-equal."""
    import airdos_tpu_torch.ops.stereo_sad as ss
    args = _sad_case(np.random.default_rng(9), "faint")
    assert any(bool(((im != 0) & (im.abs() < 2.0 ** -8)).any())
               for im in args[6])
    got, again = ss.stereo_sad(*args), ss.stereo_sad(*args)
    want = ss.stereo_sad_ref(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert float((got[3] == want[3]).float().mean()) >= 0.999
    both = got[3] & want[3]
    assert int(both.sum()) > 20
    assert float((got[1] - want[1])[both].abs().max()) <= 1e-3


def test_stereo_sad_kernel_rejects_what_it_does_not_take(cuda):
    import airdos_tpu_torch.ops.stereo_sad as ss
    args = list(_sad_case(np.random.default_rng(9), "random"))
    for i, bad in ((0, args[0].double()), (1, args[1].to(torch.int32)),
                   (2, args[2].to(torch.uint8)), (4, args[4][:-1]),
                   (6, args[6][:3]), (6, [im.cpu() for im in args[6]]),
                   (8, args[8][:3]), (9, args[9].double())):
        bad_args = list(args)
        bad_args[i] = bad
        with pytest.raises(ValueError):
            ss.stereo_sad_cuda(*bad_args)


@pytest.mark.parametrize("kind", ["integers", "fractions"])
def test_patch_disparity_kernel_equals_plain_version(cuda, kind):
    """The 40 torso probes of the path and edge cases (off the image,
    uncovered windows, padded -1 slots, half pixels), on 8-bit images and
    on images of fractions >= 1: bit-equal, one launch a call."""
    import airdos_tpu_torch.ops.disparity as dk
    rng = np.random.default_rng(3)
    h, w = 360, 640
    imL = _texture(rng, h, w + 60)
    if kind == "fractions":
        imL = (imL + 1.0) * rng.uniform(1.0, 1.5, imL.shape).astype(
            np.float32)
    imR = imL[:, 13:13 + w].copy()
    imL = imL[:, :w].copy()
    px = np.stack([rng.uniform(0, w, 40), rng.uniform(0, h, 40)],
                  axis=1).astype(np.float32)
    px[:8] = [[-1, -1], [-5, 10], [700, 30], [3, 100], [40.5, 20.5],
              [52.0, 359.4], [639.4, 0.0], [20.0, 200.0]]
    args = (torch.from_numpy(imL).to(cuda), torch.from_numpy(imR).to(cuda),
            torch.from_numpy(px).to(cuda))
    before = dk.launches()
    got = dk.patch_disparity(*args)
    again = dk.patch_disparity(*args)
    torch.cuda.synchronize()
    assert dk.launches() == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, dk.patch_disparity_ref(*args))
    assert torch.equal(got.cpu(), dk.patch_disparity_ref(
        *(a.cpu() for a in args)))
    assert int((got >= 0).sum()) >= 20


def _disparity_pair(rng, case, h, w):
    """An image pair for the kernel's cases: 8-bit uniform noise 13 px
    apart (16-bit: integers past the kernel's float32 sums, summed in
    float64), an 8-bit texture 45 px apart (minima past lane 32), or 8-bit
    textures that repeat every 16 or 32 px, 5 or 40 px apart (tied minima
    in other warps and in one lane's two SADs)."""
    if case in ("noise", "16-bit"):
        top = 256 if case == "noise" else 65536
        im = rng.integers(0, top, (h, w + 60)).astype(np.float32)
        return im[:, :w], im[:, 13:13 + w]
    if case == "far":
        im = _texture(rng, h, w + 60)
        return im[:, :w], im[:, 45:45 + w]
    period, shift = {"ties 16": (16, 5), "ties 32": (32, 40)}[case]
    im = np.tile(rng.integers(0, 256, (h, period)),
                 (1, w // period + 4)).astype(np.float32)
    return im[:, :w], im[:, shift:shift + w]


@pytest.mark.parametrize("case", ["noise", "16-bit", "far", "ties 16",
                                  "ties 32"])
@pytest.mark.parametrize("num_disp,block", [(48, 11), (64, 15), (7, 3),
                                            (33, 1)])
def test_patch_disparity_kernel_bit_equal_at_edges_and_ties(cuda, case,
                                                            num_disp, block):
    """Random 8-bit and 16-bit images, probes at every edge and corner of
    the image (half pixels, just outside, the windows cut by the clamps
    and the uncovered strips at the left edge) and inside, where the
    repeating textures' first minimum is their shift: bit-equal to the
    plain version on the card and on the CPU, two launches bit-equal."""
    import airdos_tpu_torch.ops.disparity as dk
    rng = np.random.default_rng(num_disp * 7 + block)
    h, w = 120, 200
    imL, imR = _disparity_pair(rng, case, h, w)
    edge = np.array([0.0, 0.5, 1.0, 4.4, 5.0, 6.5, 47.0, 63.5, w - 6.0,
                     w - 1.0, w - 0.6, w - 0.4, -0.4, -0.6, float(w)],
                    np.float32)
    row = np.array([0.0, 0.5, 4.0, 5.5, h - 5.0, h - 1.0, h - 0.5, -0.5,
                    float(h)], np.float32)
    px = np.concatenate([
        np.stack(np.meshgrid(edge, row), -1).reshape(-1, 2),
        np.stack([rng.uniform(60, w - 10, 64), rng.uniform(6, h - 6, 64)],
                 axis=1),
    ]).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in (imL, imR, px)]
    before = dk.launches()
    got = dk.patch_disparity(*args, num_disp=num_disp, block=block)
    again = dk.patch_disparity(*args, num_disp=num_disp, block=block)
    torch.cuda.synchronize()
    assert dk.launches() == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, dk.patch_disparity_ref(
        *args, num_disp=num_disp, block=block))
    assert torch.equal(got.cpu(), dk.patch_disparity_ref(
        *(a.cpu() for a in args), num_disp=num_disp, block=block))
    if case.startswith("ties") and num_disp == 48 and block == 11:
        inside = got[-64:]
        shift = 5 if case == "ties 16" else 8
        assert bool((inside[inside >= 0].round() == shift).all())
        assert int((inside >= 0).sum()) >= 32


def test_patch_disparity_kernel_rejects_what_it_does_not_take(cuda):
    import airdos_tpu_torch.ops.disparity as dk
    im = torch.zeros((64, 96), device=cuda)
    px = torch.zeros((40, 2), device=cuda)
    for args, kw in (((im.double(), im, px), {}), ((im.t(), im.t(), px), {}),
                     ((im, im[:32].contiguous(), px), {}),
                     ((im, im, px.double()), {}), ((im, im, px[:, :1]), {}),
                     ((im, im, px.cpu()), {}), ((im, im, px), {"num_disp": 65}),
                     ((im, im, px), {"block": 12})):
        with pytest.raises(ValueError):
            dk.patch_disparity_cuda(*args, **kw)


@pytest.mark.parametrize("k", [1, 6, 16])
def test_pyramid_kernel_erodes_with_the_window_asked(cuda, k):
    """Level 0's mask eroded k x k (build_pyramid's mask_erode), bit-equal
    to the plain version; a window past 16 is refused."""
    import airdos_tpu_torch.ops.pyramid as pk
    rng = np.random.default_rng(k)
    img, mask = _pyramid_inputs(rng, 120, 200, "uint8")
    mask[rng.random(mask.shape) < 0.01] = 0
    img_d, mask_d = torch.from_numpy(img).to(cuda), torch.from_numpy(mask).to(cuda)
    got = pk.pyramid_level_cuda(img_d, mask_d, 120, 200, True, k)
    want = pk.pyramid_level_ref(img_d, mask_d, 120, 200, True, k)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        pk.pyramid_level_cuda(img_d, mask_d, 120, 200, True, 17)
    pyr = pk.build_pyramid(img_d, mask_d, 3, 1.2, mask_erode=k)
    assert torch.equal(pyr.masks[0], got[1])


def _bits_equal(a, b):
    """Bit for bit (NaNs equal to NaNs, whatever their payload)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    a, b = a.contiguous(), b.to(a.device).contiguous()
    same = a.view(torch.int32) == b.view(torch.int32)
    return bool((same | (torch.isnan(a) & torch.isnan(b))).all())


def _rotations(rng, n):
    w = rng.normal(0, 0.2, (n, 3))
    th = np.linalg.norm(w, axis=1, keepdims=True)
    k = w / th
    K = np.zeros((n, 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(0, 2, 1)
    s, c = np.sin(th)[:, :, None], np.cos(th)[:, :, None]
    return (np.eye(3) + s * K + (1 - c) * K @ K).astype(np.float32)


BA_CAM = (458.654, 457.296, 367.215, 248.375, 50.0)


def _static_case(rng, E, C, P):
    """A local BA's edge table: mono edges, a quarter padding (camera 0,
    point 0, inactive), points behind and on the camera plane, residuals
    past the Huber deltas and one observation that is infinite."""
    R = _rotations(rng, C)
    t = rng.normal(0, 0.3, (C, 3)).astype(np.float32)
    pts = rng.uniform([-4, -2, 3], [4, 2, 15], (P, 3)).astype(np.float32)
    pts[:4, 2] = [-2.0, 0.0, 1e-7, -1e-7]
    R[0], t[0] = np.eye(3, dtype=np.float32), 0.0
    e_cam = rng.integers(0, C, E).astype(np.int32)
    e_pt = rng.integers(0, P, E).astype(np.int32)
    e_cam[:4], e_pt[:4] = 0, np.arange(4)
    xc = np.einsum("eij,ej->ei", R[e_cam], pts[e_pt]) + t[e_cam]
    fx, fy, cx, cy, bf = BA_CAM
    z = np.where(np.abs(xc[:, 2]) < 1e-3, 1.0, xc[:, 2])
    obs = np.stack([fx * xc[:, 0] / z + cx, fy * xc[:, 1] / z + cy,
                    fx * xc[:, 0] / z + cx - bf / z], 1)
    obs += rng.normal(0, 2.0, obs.shape)
    obs[rng.random(E) < 0.3, 2] = -1.0
    obs[5] = [np.inf, 1.0, 1.0]
    info = rng.uniform(0.3, 1.5, E).astype(np.float32)
    active = (rng.random(E) > 0.1).astype(np.float32)
    pad = rng.random(E) < 0.25
    pad[:8] = False
    e_cam[pad], e_pt[pad], active[pad], obs[pad] = 0, 0, 0.0, 0.0
    return (R, t, pts, e_cam, e_pt, obs.astype(np.float32), info, active)


@pytest.mark.parametrize("E,C,P", [(8192, 24, 2048), (16384, 48, 4096),
                                   (8192, 128, 4096), (1001, 5, 300)])
@pytest.mark.parametrize("huber,scale", [(True, 1.0), (False, 1.0),
                                         (True, 0.7)])
def test_static_edge_blocks_kernel_equals_plain_version(cuda, E, C, P,
                                                        huber, scale):
    """Rows (Gauss-Newton mode) and rho, chi2, z (cost mode) bit-equal to
    the plain version on the card and on the CPU, one launch a call."""
    import airdos_tpu_torch.ops.ba_static as bs
    rng = np.random.default_rng(E + C + P)
    case = _static_case(rng, E, C, P)
    args = [torch.from_numpy(a).to(cuda) for a in case]
    before = bs.launches()
    rows = bs.static_edge_blocks(*args, BA_CAM, scale, huber)
    cost = bs.static_edge_cost(*args[:7], BA_CAM, scale, huber)
    torch.cuda.synchronize()
    assert bs.launches() == before + 2
    for mode, got in ((False, rows), (True, cost)):
        want = bs.static_edges_ref(*args, BA_CAM, scale, huber, mode)
        want_cpu = bs.static_edges_ref(*(a.cpu() for a in args), BA_CAM,
                                       scale, huber, mode)
        for name, a, b, c in zip(got._fields, got, want, want_cpu):
            assert _bits_equal(a, b), (mode, name)
            assert _bits_equal(a, c), (mode, name, "cpu")
    assert not torch.isfinite(cost.rho[5])
    assert torch.all(rows.cam[args[7] == 0] == 0)


@pytest.mark.parametrize("case", ["8192x24", "4096x24", "2048x48", "64x3",
                                  "mono", "one camera", "40960x24",
                                  "empty"])
@pytest.mark.parametrize("huber", [True, False])
def test_static_edge_modes_bit_equal_at_the_path_shapes(cuda, case, huber):
    """Gauss-Newton rows, the chi-square passes' costs and the fused LM
    cost bit-equal to the plain version on the card and on the CPU at the
    paths' edge tables; the fused cost bit-equal to lm_cost of the cost
    mode's rho (lm_cost_ref on the card); one launch a call."""
    import airdos_tpu_torch.ops.ba_static as bs
    import airdos_tpu_torch.ops.lm_cost as lc
    E, C, P = {"8192x24": (8192, 24, 2048), "4096x24": (4096, 24, 1024),
               "2048x48": (2048, 48, 2048), "64x3": (64, 3, 20),
               "mono": (3000, 8, 500), "one camera": (2000, 1, 400),
               "40960x24": (40960, 24, 8192), "empty": (0, 4, 10)}[case]
    rng = np.random.default_rng(E + C + huber)
    arrays = list(_static_case(rng, max(E, 8), C, P))
    if E == 0:
        arrays = [a[:0] if i >= 3 else a for i, a in enumerate(arrays)]
    if case == "mono":
        arrays[5][:, 2] = -1.0
    if E > 6:
        arrays[5][6] = [np.nan, 1.0, 1.0]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in arrays]
    before = bs.launches()
    rows = bs.static_edge_blocks(*args, BA_CAM, 1.0, huber)
    cost = bs.static_edge_cost(*args[:7], BA_CAM, 1.0, huber)
    total = bs.static_edge_cost_sum(*args, BA_CAM, 1.0, huber)
    again = bs.static_edge_cost_sum(*args, BA_CAM, 1.0, huber)
    torch.cuda.synchronize()
    assert bs.launches() == before + 4 - (E == 0) * 2
    assert _bits_equal(total, again)
    assert _bits_equal(total, lc.lm_cost_ref(cost.rho, args[7]))
    for mode, got in ((bs.ROWS, tuple(rows)), (bs.COST, tuple(cost)),
                      (bs.COST_SUM, (total,))):
        want = bs.static_edges_ref(*args, BA_CAM, 1.0, huber, mode)
        want_cpu = bs.static_edges_ref(*(a.cpu() for a in args), BA_CAM, 1.0,
                                       huber, mode)
        if mode == bs.COST_SUM:
            want, want_cpu = (want,), (want_cpu,)
        for k, (a, b, c) in enumerate(zip(got, want, want_cpu)):
            assert _bits_equal(a, b), (mode, k)
            assert _bits_equal(a, c), (mode, k, "cpu")


def _landmark_case(rng, P, C):
    """Segment sums of a landmark Schur step: rank-1 and rank-2 blocks,
    empty and invalid points, cameras that do not see a point, a fixed
    camera (zero step)."""
    J = rng.normal(0, 30, (P, 4, 3))
    J[: P // 8, 1:] = 0.0                          # one row: rank 1
    J[P // 8: P // 4, 2:] = 0.0                    # rank 2
    J[P // 4: P // 4 + 3] = 0.0                    # no edge at all
    Hpp = np.einsum("pik,pil->pkl", J, J)
    pt_sums = np.concatenate([Hpp.reshape(P, 9), rng.normal(0, 10, (P, 3))],
                             1).astype(np.float32)
    wagg = rng.normal(0, 5, (P, C, 18)).astype(np.float32)
    wagg[rng.random((P, C)) < 0.7] = 0.0
    valid = rng.random(P) > 0.1
    dx_c = rng.normal(0, 1e-2, (C, 6)).astype(np.float32)
    dx_c[0] = 0.0
    return pt_sums, wagg.reshape(P, C * 18), valid, dx_c


@pytest.mark.parametrize("P,C", [(2048, 24), (4096, 48), (4096, 128),
                                 (37, 70), (173, 7), (999, 3), (5, 3),
                                 (1, 1)])
@pytest.mark.parametrize("lam", [8.1e-9, 1e-6, 4e3])
def test_landmark_schur_kernels_equal_plain_version(cuda, P, C, lam):
    """The reduction (Hpp^-1, Aagg) and the back-substitution bit-equal to
    their plain versions on the card and on the CPU, one launch each; odd
    C and odd P C (a thread's rows across two points, the reduce's last
    rows one at a time) and P below one block of either launch."""
    import airdos_tpu_torch.ops.ba_points as bp
    rng = np.random.default_rng(P + C)
    pt_sums, wagg, valid, dx_c = (torch.from_numpy(a).to(cuda) for a in
                                  _landmark_case(rng, P, C))
    lam_d = torch.tensor(lam, dtype=torch.float32, device=cuda)
    r0, b0 = bp.reduce_launches(), bp.backsub_launches()
    hinv, aagg = bp.landmark_reduce(pt_sums, wagg, valid, lam_d)
    dx_p = bp.landmark_backsub(hinv, pt_sums, wagg, dx_c, valid)
    torch.cuda.synchronize()
    assert (bp.reduce_launches(), bp.backsub_launches()) == (r0 + 1, b0 + 1)
    for got, want, cpu in (
            ((hinv, aagg), bp.landmark_reduce_ref(pt_sums, wagg, valid,
                                                  lam_d),
             bp.landmark_reduce_ref(pt_sums.cpu(), wagg.cpu(), valid.cpu(),
                                    lam_d.cpu())),
            ((dx_p,), (bp.landmark_backsub_ref(hinv, pt_sums, wagg, dx_c,
                                               valid),),
             (bp.landmark_backsub_ref(hinv.cpu(), pt_sums.cpu(), wagg.cpu(),
                                      dx_c.cpu(), valid.cpu()),))):
        for a, b, c in zip(got, want, cpu):
            assert _bits_equal(a, b)
            assert _bits_equal(a, c)
    assert torch.all(hinv[~valid] == 0) and torch.all(dx_p[~valid] == 0)
    assert torch.isfinite(hinv[valid]).all()


@pytest.mark.parametrize("P,C", [(2048, 24), (173, 7)])
@pytest.mark.parametrize("shift", [1, 2, 3])
def test_landmark_schur_kernels_take_wagg_at_any_base(cuda, P, C, shift):
    """A Wagg view `shift` floats past a 16-byte boundary (the wrappers
    copy it to 16 bytes for the kernels' vector loads) gives the bits of
    the aligned tensor and of the plain versions, one launch each."""
    import airdos_tpu_torch.ops.ba_points as bp
    rng = np.random.default_rng(P * C + shift)
    pt_sums, wagg, valid, dx_c = (torch.from_numpy(a).to(cuda) for a in
                                  _landmark_case(rng, P, C))
    buf = torch.empty(wagg.numel() + 4, dtype=torch.float32, device=cuda)
    moved = buf[shift:shift + wagg.numel()].view(P, C * 18)
    moved.copy_(wagg)
    assert moved.data_ptr() % 16 == 4 * shift
    lam = torch.tensor(1e-6, dtype=torch.float32, device=cuda)
    r0, b0 = bp.reduce_launches(), bp.backsub_launches()
    got = bp.landmark_reduce(pt_sums, moved, valid, lam)
    dx_p = bp.landmark_backsub(got[0], pt_sums, moved, dx_c, valid)
    assert (bp.reduce_launches(), bp.backsub_launches()) == (r0 + 1, b0 + 1)
    want = bp.landmark_reduce(pt_sums, wagg, valid, lam)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _bits_equal(a, b)
    for a, b in zip(got, bp.landmark_reduce_ref(pt_sums.cpu(), wagg.cpu(),
                                                valid.cpu(), lam.cpu())):
        assert _bits_equal(a, b)
    assert _bits_equal(dx_p, bp.landmark_backsub(want[0], pt_sums, wagg,
                                                 dx_c, valid))
    assert _bits_equal(dx_p, bp.landmark_backsub_ref(
        want[0].cpu(), pt_sums.cpu(), wagg.cpu(), dx_c.cpu(), valid.cpu()))


def _human_case(rng, T, L, C, device):
    import airdos_tpu_torch.solvers.human_ba as thba
    N = 14
    exists = rng.random((T, L, N)) > 0.1
    jo_cam = rng.integers(-1, C, (T, L))
    ed = thba.human_edges(
        torch.from_numpy(jo_cam).to(device),
        torch.from_numpy(rng.normal(300, 80, (T, L, N, 3)).astype(np.float32))
        .to(device), torch.from_numpy(rng.random((T, L, N)) > 0.2).to(device),
        torch.from_numpy(exists).to(device),
        torch.from_numpy(rng.random((T, L, N)) > 0.1).to(device),
        torch.from_numpy(rng.random(T) > 0.2).to(device),
        torch.from_numpy(rng.uniform(0.1, 0.3, (T, L)).astype(np.float32))
        .to(device), torch.from_numpy(rng.random((T, L, 5)) > 0.1).to(device),
        C)
    obs = ed.tables.hp_obs.clone()
    obs[torch.from_numpy(rng.random(obs.shape[0]) < 0.3).to(device), 2] = -1.0
    tb = ed.tables._replace(hp_obs=obs)
    act = [v.to(torch.float32) for v in (ed.hp_valid, ed.rg_valid,
                                         ed.mo_valid)]
    joints = rng.uniform([-1, -1, 2], [1, 1, 8], (T, L, N, 3))
    joints[0, 0, 0, 2] = -1.0                      # behind its camera
    state = (_rotations(rng, C), rng.normal(0, 0.2, (C, 3)), joints,
             rng.uniform(0.2, 0.6, (T, N)), _rotations(rng, T),
             rng.normal(0, 0.5, (T, 3)))
    state = [torch.from_numpy(np.asarray(x, np.float32)).to(device)
             for x in state]
    return state, tb, act


HUMAN_SIG = (0.5, 20.0, 20.0, 2.795483, 1.0, 1.0)


@pytest.mark.parametrize("T,L", [(8, 8), (1, 4), (3, 1), (3, 3), (10, 20)])
@pytest.mark.parametrize("huber", [True, False])
def test_human_edge_blocks_kernel_equals_plain_version(cuda, T, L, huber):
    """The families' column (Gauss-Newton mode), rho, chi2, depths (cost
    mode) and LM costs (cost-sum mode) bit-equal to the plain version on
    the card and on the CPU and across two launches, one launch a call:
    896 / 896 / 280 edges (crowd-27), 56 / 56 / 15, L = 1 (no motion
    edge), 126 / 126 / 30 (family offsets off 16 bytes) and 2800 / 2800 /
    950; the cost sums also bit-equal to lm_cost_ref of the cost mode's
    rho on the card."""
    import airdos_tpu_torch.ops.ba_human as bh
    import airdos_tpu_torch.ops.lm_cost as lc
    rng = np.random.default_rng(T * 100 + L)
    state, tb, act = _human_case(rng, T, L, 24, cuda)
    lt = bh.launch_tables(tb)
    cpu_tb = bh.HumanTables(*(x.cpu() for x in tb))
    calls = {bh.ROWS: lambda t: (bh.human_edge_blocks(
                 *state, t, act, BA_CAM, HUMAN_SIG, huber),),
             bh.COST: lambda t: bh.human_edge_cost(
                 *state, t, BA_CAM, HUMAN_SIG, huber),
             bh.COST_SUM: lambda t: (bh.human_edge_cost_sum(
                 *state, t, act, BA_CAM, HUMAN_SIG, huber),)}
    for mode, call in calls.items():
        before = bh.launches()
        got, again = call(lt), call(tb)
        torch.cuda.synchronize()
        assert bh.launches() == before + 2
        want = bh.human_edges_ref(*state, tb, act, BA_CAM, HUMAN_SIG, huber,
                                  mode)
        want_cpu = bh.human_edges_ref(*(x.cpu() for x in state), cpu_tb,
                                      [a.cpu() for a in act], BA_CAM,
                                      HUMAN_SIG, huber, mode)
        if mode != bh.COST:
            want, want_cpu = (want,), (want_cpu,)
        for a, b, c, d in zip(got, again, want, want_cpu):
            assert _bits_equal(a, b), (mode, "again")
            assert _bits_equal(a, c), mode
            assert _bits_equal(a, d), (mode, "cpu")
    assert got[0].shape == (3,)
    rho = bh.human_edge_cost(*state, lt, BA_CAM, HUMAN_SIG, huber).rho
    sums = [lc.lm_cost_ref(r, a)
            for r, a in zip(rho.split(list(bh.family_sizes(tb))), act)]
    assert _bits_equal(got[0], torch.stack(sums))
    assert calls[bh.ROWS](lt)[0].shape == (bh.n_values(tb),)


def test_human_edge_blocks_kernel_rejects_what_it_does_not_take(cuda):
    import airdos_tpu_torch.ops.ba_human as bh
    state, tb, act = _human_case(np.random.default_rng(5), 2, 3, 3, cuda)
    lt = bh.launch_tables(tb)
    with pytest.raises(ValueError):
        bh.launch_tables(tb._replace(hp_cam=tb.hp_cam.long()))
    with pytest.raises(ValueError):
        bh.launch_tables(tb._replace(mo_dt=tb.mo_dt[:-1]))
    with pytest.raises(ValueError):
        bh.launch_tables(bh.HumanTables(*(x.cpu() for x in tb)))
    with pytest.raises(ValueError):
        bh.human_edge_cost_sum(*state, lt, act[:2] + [act[2][:-1]], BA_CAM,
                               HUMAN_SIG, True)
    with pytest.raises(ValueError):
        bh.human_edges_cuda(*state, lt, act, BA_CAM, HUMAN_SIG, True, 3)
    with pytest.raises(ValueError):
        bh.human_edge_blocks(state[0], state[1], state[2].double(),
                             *state[3:], lt, act, BA_CAM, HUMAN_SIG, True)


def test_ba_kernel_dispatchers_raise_without_their_library(cuda, monkeypatch,
                                                            tmp_path):
    """With no library to load, a dispatcher given CUDA tensors raises; it
    never runs the plain version instead."""
    import airdos_tpu_torch.ops.ba_human as bh
    import airdos_tpu_torch.ops.ba_points as bp
    import airdos_tpu_torch.ops.ba_static as bs

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on CUDA tensors")

    missing = tmp_path / "missing.cu"
    for mod, ref, loaded in ((bs, "static_edges_ref", "_kernel"),
                             (bp, "landmark_reduce_ref", "_lib"),
                             (bp, "landmark_backsub_ref", "_lib"),
                             (bh, "human_edges_ref", "_kernel")):
        monkeypatch.setattr(mod, "_SOURCE", missing)
        monkeypatch.setattr(mod, loaded, None)
        monkeypatch.setattr(mod, ref, plain)
    rng = np.random.default_rng(0)
    static = [torch.from_numpy(a).to(cuda)
              for a in _static_case(rng, 64, 3, 20)]
    pt_sums, wagg, valid, dx_c = (torch.from_numpy(a).to(cuda) for a in
                                  _landmark_case(rng, 20, 3))
    state, tb, act = _human_case(rng, 2, 3, 3, cuda)
    lam = torch.tensor(1e-6, device=cuda)
    calls = (
        lambda: bs.static_edge_blocks(*static, BA_CAM, 1.0, True),
        lambda: bs.static_edge_cost(*static[:7], BA_CAM, 1.0, True),
        lambda: bs.static_edge_cost_sum(*static, BA_CAM, 1.0, True),
        lambda: bp.landmark_reduce(pt_sums, wagg, valid, lam),
        lambda: bp.landmark_backsub(torch.zeros((20, 3, 3), device=cuda),
                                    pt_sums, wagg, dx_c, valid),
        lambda: bh.human_edge_blocks(*state, tb, act, BA_CAM, HUMAN_SIG,
                                     True),
        lambda: bh.human_edge_cost(*state, tb, BA_CAM, HUMAN_SIG, True),
        lambda: bh.human_edge_cost_sum(*state, tb, act, BA_CAM, HUMAN_SIG,
                                       True))
    for call in calls:
        with pytest.raises(FileNotFoundError):
            call()


# ------------------------------------------------------ the matcher kernels

def _match_case(rng, mode, P, N, device):
    """A matcher's rows and columns shaped as the tracking path gives them:
    columns spread over a 640 x 360 image at 8 octaves; about 70% of the
    rows derived from a column (its position moved by a few pixels, a few
    descriptor bits flipped), the rest random; duplicated columns make
    ties.  -> (MatchRows, MatchCols, th, ratio, band, max_d)"""
    import airdos_tpu_torch.ops.match_kernels as mk
    cd = _words(rng, (N, 8))
    cd[N // 2::7] = cd[N // 2 - 1::7][:len(cd[N // 2::7])]   # duplicates
    ck = rng.integers(0, 8, N)
    cx = rng.uniform(0, 640, N).astype(np.float32)
    cy = rng.uniform(0, 360, N).astype(np.float32)
    src = rng.integers(0, N, P)
    derived = rng.uniform(size=P) < 0.7
    rd = np.where(derived[:, None], cd[src], _words(rng, (P, 8)))
    flips = rng.integers(0, 32, (P, 8))
    rd ^= np.where(rng.uniform(size=(P, 8)) < 0.3,
                   np.left_shift(np.uint32(1), flips.astype(np.uint32)),
                   np.uint32(0)).astype(np.uint32)
    rk = np.clip(ck[src] + rng.integers(-1, 2, P), 0, 7)
    th, ratio, band, max_d = 100, 0.0, (None, None), 0.0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if mode == mk.BOW:
        ck = rng.integers(-1, 12, N)
        rk = np.where(derived, ck[src], rng.integers(-1, 12, P))
        rows = mk.MatchRows(t(rd.view(np.int32)), t(rk),
                            t(rng.uniform(size=P) < 0.95))
        cols = mk.MatchCols(t(cd.view(np.int32)), t(ck),
                            t(rng.uniform(size=N) < 0.95))
        return rows, cols, 49, 0.7, band, max_d
    if mode == mk.STEREO:
        rx = (cx[src] + rng.uniform(0, 60, P)).astype(np.float32)
        ry = (cy[src] + rng.uniform(-2, 2, P)).astype(np.float32)
        xy_l = np.stack([rx, ry], 1)
        xy_r = np.stack([cx, cy], 1)
        rows = mk.MatchRows(t(rd.view(np.int32)), t(rk),
                            t(rng.uniform(size=P) < 0.95),
                            t(xy_l)[:, 0], t(xy_l)[:, 1])
        cols = mk.MatchCols(t(cd.view(np.int32)), t(ck),
                            t(rng.uniform(size=N) < 0.95),
                            t(xy_r)[:, 0], t(xy_r)[:, 1],
                            t((2.0 * 1.2 ** ck).astype(np.float32)))
        return rows, cols, 74, 0.9, band, 48.0
    u = (cx[src] + rng.normal(0, 3, P)).astype(np.float32)
    v = (cy[src] + rng.normal(0, 3, P)).astype(np.float32)
    cur = np.where(rng.uniform(size=N) < 0.7,
                   cx - rng.uniform(1, 40, N), -1).astype(np.float32)
    ur = (u - rng.uniform(1, 40, P)).astype(np.float32)
    radius = (7.0 * 1.2 ** rk).astype(np.float32)
    rows = mk.MatchRows(t(rd.view(np.int32)), t(rk),
                        t(rng.uniform(size=P) < 0.9), t(u), t(v), t(ur),
                        t(radius))
    cols = mk.MatchCols(t(cd.view(np.int32)), t(ck),
                        t(rng.uniform(size=N) < 0.95), t(cx), t(cy), t(cur),
                        t(rng.uniform(size=N) < 0.1))
    if mode == mk.LOCAL:
        return rows, cols, 100, 0.8, (-1, 0), max_d
    return rows, cols, 100, 0.0, [(0, None), (None, 0), (-1, 1)][P % 3], \
        max_d


_MATCH_SHAPES = [(2048, 1536), (1536, 1536), (37, 45), (1, 70), (300, 1)]


@pytest.mark.parametrize("P,N", _MATCH_SHAPES)
@pytest.mark.parametrize("mode", ["motion", "local", "stereo", "bow"])
def test_match_rows_kernel_bit_equal_and_deterministic(cuda, mode, P, N):
    import airdos_tpu_torch.ops.match_kernels as mk
    m = ("motion", "local", "stereo", "bow").index(mode)
    rng = np.random.default_rng(P * 31 + N + m)
    rows, cols, th, ratio, band, max_d = _match_case(rng, m, P, N, cuda)
    before = mk.launches()
    got = mk.match_rows(m, rows, cols, th, ratio, band, max_d)
    again = mk.match_rows(m, rows, cols, th, ratio, band, max_d)
    torch.cuda.synchronize()
    assert mk.launches() == before + 2
    want = mk.match_rows_ref(m, rows, cols, th, ratio, band, max_d)
    cpu = lambda x: None if x is None else x.cpu()
    want_cpu = mk.match_rows_ref(m, mk.MatchRows(*map(cpu, rows)),
                                 mk.MatchCols(*map(cpu, cols)), th, ratio,
                                 band, max_d)
    for name in mk.RowMatches._fields:
        g = getattr(got, name)
        assert torch.equal(g, getattr(want, name)), name
        assert torch.equal(g.cpu(), getattr(want_cpu, name)), name
        assert torch.equal(g, getattr(again, name)), name
    if P >= 1536:
        assert int(got.has.sum()) > 50


@pytest.mark.parametrize("case", ["path", "ties", "rows at BIG"])
@pytest.mark.parametrize("rotation", [True, False])
def test_match_resolve_kernel_bit_equal_and_deterministic(cuda, case,
                                                          rotation):
    """The resolve folded into match_rows' launch (motion and BoW with the
    rotation filter or not, local without): feat_idx, point_of_feat and n
    equal to match_resolve_ref on the kernel's rows, one launch a call."""
    import airdos_tpu_torch.ops.match_kernels as mk
    for m in (mk.MOTION, mk.BOW) if rotation else (mk.LOCAL, mk.BOW):
        rng = np.random.default_rng(len(case) + rotation + 10 * m)
        rows, cols, th, ratio, band, max_d = _match_case(rng, m, 2048, 1536,
                                                         cuda)
        if case == "ties":          # one descriptor: every distance 0
            one = cols.desc[:1]
            cols = cols._replace(desc=one.expand(1536, 8).contiguous())
            rows = rows._replace(desc=one.expand(2048, 8).contiguous())
        elif case == "rows at BIG":   # rows with no gated pair claim too
            th = mk.BIG
        P = rows.desc.shape[0]
        ang_ref = torch.from_numpy(rng.uniform(0, 360, P).astype(np.float32))
        ang_tab = torch.from_numpy(rng.uniform(0, 360, 1536).astype(np.float32))
        angles = (ang_ref.to(cuda), ang_tab.to(cuda)) if rotation else None
        before = (mk.launches(), mk.resolve_launches())
        got = mk.match_rows(m, rows, cols, th, ratio, band, max_d, True, angles)
        again = mk.match_rows(m, rows, cols, th, ratio, band, max_d, True,
                              angles)
        torch.cuda.synchronize()
        assert (mk.launches(), mk.resolve_launches()) == \
            (before[0] + 2, before[1] + 2)
        bare = mk.match_rows_ref(m, rows, cols, th, ratio, band, max_d)
        want = mk.match_resolve_ref(bare.best, bare.dist, bare.has, 1536,
                                    *(angles or (None, None)))
        for name, w in zip(("feat_idx", "point_of_feat", "n"), want):
            assert torch.equal(getattr(got, name), w), (m, name)
            assert torch.equal(getattr(again, name), w), (m, name)
        # BoW's ratio test (dist < 0.7 second) drops every exact tie
        assert int(got.n) > 0 or (case == "ties" and m == mk.BOW)


@pytest.mark.parametrize("B,P,N", [(9, 2048, 1536), (1, 2048, 1536),
                                   (3, 37, 45)])
def test_match_rows_fuse_kernel_bit_equal_and_deterministic(cuda, B, P, N):
    """Fuse mode at fusion's shapes (a keyframe's neighbourhood, B = 9,
    and SearchAndFuse, B = 1): every output bit-equal to the plain
    version on the card and on the CPU, one launch a call, no batched
    Hamming launch."""
    import airdos_tpu_torch.ops.match_kernels as mk
    import torch_match_cases as tc
    c = tc.make(mk.FUSE, "path", np.random.default_rng(B * P + N), P, N, B)
    args = tc.args(c, cuda)
    before = (mk.launches(), mk.fuse_launches(), hk.batched_launches())
    got = mk.match_rows(*args)
    again = mk.match_rows(*args)
    torch.cuda.synchronize()
    assert (mk.launches(), mk.fuse_launches(), hk.batched_launches()) == \
        (before[0] + 2, before[1] + 2, before[2])
    want = mk.match_rows_ref(*args)
    want_cpu = mk.match_rows_ref(*tc.args(c))
    for name in mk.RowMatches._fields:
        g = getattr(got, name)
        assert torch.equal(g, getattr(want, name)), name
        assert torch.equal(g.cpu(), getattr(want_cpu, name)), name
        assert torch.equal(g, getattr(again, name)), name
    assert int((got.feat_idx >= 0).sum()) > P // 20


@pytest.mark.parametrize("case", ["path", "border", "cell boundaries",
                                  "non-finite", "one cell", "empty windows",
                                  "no gated pair", "wide windows"])
@pytest.mark.parametrize("mode", ["motion", "local", "stereo", "bow", "fuse",
                                  "epipolar"])
def test_match_rows_grid_edge_cases_bit_equal(cuda, mode, case):
    """The grid of cells' edge cases (tests/torch_match_cases.py) in every
    mode, with the resolve where the mode has it: every output bit-equal
    to the plain version, two launches equal."""
    import airdos_tpu_torch.ops.match_kernels as mk
    import torch_match_cases as tc
    m = tc.MODES.index(mode)
    for P, N in ((48, 96), (300, 500)):
        rng = np.random.default_rng(1000 * m + 10 * tc.CASES.index(case) + P)
        args = tc.args(tc.make(m, case, rng, P, N, 3), cuda)
        got, again = mk.match_rows(*args), mk.match_rows(*args)
        want = mk.match_rows_ref(*args)
        for name in mk.RowMatches._fields:
            assert torch.equal(getattr(got, name), getattr(want, name)), name
            assert torch.equal(getattr(got, name), getattr(again, name)), name


def test_match_kernels_raise_on_cpu_mixed_inputs(cuda):
    import airdos_tpu_torch.ops.match_kernels as mk
    rng = np.random.default_rng(3)
    rows, cols, th, ratio, band, max_d = _match_case(rng, mk.LOCAL, 64, 80,
                                                     cuda)
    with pytest.raises(ValueError):
        mk.match_rows(mk.LOCAL, rows, cols._replace(ok=cols.ok.cpu()), th,
                      ratio, band)
    with pytest.raises(ValueError):
        mk.match_rows(mk.LOCAL, rows, cols._replace(desc=cols.desc.cpu()),
                      th, ratio, band)
    with pytest.raises(ValueError):
        mk.match_rows(mk.LOCAL, rows._replace(radius=None), cols, th, ratio,
                      band)
    angles = (torch.zeros(64, device=cuda), torch.zeros(80, device=cuda))
    with pytest.raises(ValueError):     # angles on the CPU
        mk.match_rows(mk.MOTION, rows, cols, th, ratio, band, resolve=True,
                      angles=(angles[0].cpu(), angles[1]))
    with pytest.raises(ValueError):     # a table of the rows' length
        mk.match_rows(mk.MOTION, rows, cols, th, ratio, band, resolve=True,
                      angles=(angles[0], angles[0]))
    with pytest.raises(ValueError):     # stereo has no resolve
        mk.match_rows(mk.STEREO, rows, cols._replace(taken=None), th, ratio,
                      resolve=True)
    with pytest.raises(ValueError):     # fuse needs its sigma2 table
        mk.match_rows(mk.FUSE, rows, cols, th)
    with pytest.raises(ValueError):     # epipolar needs its lines
        mk.match_rows(mk.EPIPOLAR, rows, cols, th)


@pytest.mark.parametrize("B,P,N", [(4, 1536, 1536), (4, 640, 640),
                                   (3, 37, 45), (1, 300, 1)])
def test_match_rows_epipolar_kernel_bit_equal_and_deterministic(cuda, B, P,
                                                                 N):
    """Epipolar mode at triangulation's shapes (4 neighbours of 1536
    features, long-110's 640): every output bit-equal to the plain
    version on the card and on the CPU, one launch a call, counted as
    epipolar, no Hamming launch."""
    import airdos_tpu_torch.ops.match_kernels as mk
    import torch_match_cases as tc
    c = tc.make(mk.EPIPOLAR, "path", np.random.default_rng(B * P + N), P, N,
                B)
    args = tc.args(c, cuda)
    before = (mk.launches(), mk.epipolar_launches(), hk.launches(),
              hk.batched_launches())
    got = mk.match_rows(*args)
    again = mk.match_rows(*args)
    torch.cuda.synchronize()
    assert (mk.launches(), mk.epipolar_launches(), hk.launches(),
            hk.batched_launches()) == (before[0] + 2, before[1] + 2,
                                       before[2], before[3])
    want = mk.match_rows_ref(*args)
    want_cpu = mk.match_rows_ref(*tc.args(c))
    for name in mk.RowMatches._fields:
        g = getattr(got, name)
        assert torch.equal(g, getattr(want, name)), name
        assert torch.equal(g.cpu(), getattr(want_cpu, name)), name
        assert torch.equal(g, getattr(again, name)), name
    if P >= 640:
        assert int(got.has.sum()) > P // 20


def _scene_on(device, *args, **kwargs):
    import torch_triangulate_cases as ttc
    return [a.to(device) if torch.is_tensor(a) else a
            for a in ttc.scene(*args, **kwargs)]


@pytest.mark.parametrize("case", ["path", "same pose", "long-110"])
def test_triangulate_kernel_bit_equal_to_plain_version(cuda, case):
    """triangulate (csrc/triangulate.cu) on the rows triangulate_pair
    hands it, 4 neighbours of 1536 features (a neighbour at the
    keyframe's pose: the stereo points; long-110's 640): every output
    bit-equal to triangulate_rows_ref on the card, two launches equal."""
    import airdos_tpu_torch.matching.epipolar as epi
    import airdos_tpu_torch.ops.triangulate_kernels as tk
    n = 640 if case == "long-110" else 1536
    args = _scene_on(cuda, 11, B=4, N1=n, N2=n, same_pose=case == "same pose")
    seen = []
    rows = epi.triangulate_rows

    def spy(*a):
        seen.append(a)
        return rows(*a)

    epi.triangulate_rows = spy
    try:
        epi.triangulate_pair(*args)
    finally:
        epi.triangulate_rows = rows
    a = seen[0]
    before = tk.launches()
    got, again = tk.triangulate_rows(*a), tk.triangulate_rows(*a)
    want = tk.triangulate_rows_ref(*a)
    torch.cuda.synchronize()
    assert tk.launches() == before + 2
    for name in tk.TriangulationResult._fields:
        g = getattr(got, name)
        assert torch.equal(g, getattr(want, name)), name
        assert torch.equal(g, getattr(again, name)), name
    assert int(got.valid.sum()) > 50


def test_triangulate_pair_launches_its_two_kernels(cuda, monkeypatch):
    """triangulate_pair on the card: one epipolar match_rows and one
    triangulate launch, no Hamming launch, and the outputs of the same
    call with both kernels' plain versions on the card."""
    import airdos_tpu_torch.matching.epipolar as epi
    import airdos_tpu_torch.ops.match_kernels as mk
    import airdos_tpu_torch.ops.triangulate_kernels as tk
    args = _scene_on(cuda, 12, B=4, N1=1536, N2=1536)
    before = (mk.launches(), mk.epipolar_launches(), tk.launches(),
              hk.launches(), hk.batched_launches())
    got = epi.triangulate_pair(*args)
    torch.cuda.synchronize()
    assert (mk.launches(), mk.epipolar_launches(), tk.launches(),
            hk.launches(), hk.batched_launches()) == \
        (before[0] + 1, before[1] + 1, before[2] + 1, before[3], before[4])
    monkeypatch.setattr(mk, "match_rows_cuda",
                        lambda *a, **k: mk.match_rows_ref(*a[:10]))
    monkeypatch.setattr(tk, "triangulate_rows_cuda", tk.triangulate_rows_ref)
    want = epi.triangulate_pair(*args)
    for name in tk.TriangulationResult._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert int(got.valid.sum()) > 100


def test_triangulate_kernel_rejects_what_it_does_not_take(cuda):
    import airdos_tpu_torch.matching.epipolar as epi
    import airdos_tpu_torch.ops.triangulate_kernels as tk
    args = _scene_on(cuda, 13, B=2, N1=64, N2=60)
    seen = []
    rows = epi.triangulate_rows
    epi.triangulate_rows = lambda *a: seen.append(a) or rows(*a)
    try:
        epi.triangulate_pair(*args)
    finally:
        epi.triangulate_rows = rows
    a = list(seen[0])
    for i, bad in ((2, a[2].cpu()), (1, a[1].long()), (8, a[8][:, :10]),
                   (12, a[12].double()), (0, a[0][:1])):
        with pytest.raises(ValueError):
            tk.triangulate_rows(*(a[:i] + [bad] + a[i + 1:]))


def test_match_by_sim3_on_match_rows_on_the_card(cuda):
    """The loop's Sim3 match on the card: two match_rows launches (one a
    direction), no Hamming launch, and the plain versions' result on the
    card."""
    import airdos_tpu_torch.matching.sim3_match as sm
    import airdos_tpu_torch.ops.match_kernels as mk
    rng = np.random.default_rng(14)
    N = 1536
    pts = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N),
                    rng.uniform(3, 25, N)], 1).astype(np.float32)
    fx = fy = 400.0
    cx, cy, w, h = 320.0, 180.0, 640, 360
    R2 = np.array([[np.cos(0.1), 0, np.sin(0.1)], [0, 1, 0],
                   [-np.sin(0.1), 0, np.cos(0.1)]], np.float32)
    t2 = np.array([0.5, 0.1, -0.3], np.float32)
    x2 = pts @ R2.T + t2
    x1_in_c2 = x2.astype(np.float32)
    x2_in_c1 = pts.astype(np.float32)

    def feats(xc):
        return np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                         fy * xc[:, 1] / xc[:, 2] + cy], 1).astype(np.float32)

    k = rng.integers(0, 6, N)
    desc = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    d = t(desc.view(np.int32))
    maxd1 = (np.linalg.norm(x1_in_c2, axis=1) * 1.05 * 1.2 ** k)
    maxd2 = (np.linalg.norm(x2_in_c1, axis=1) * 1.05 * 1.2 ** k)
    valid = t(rng.uniform(size=N) < 0.9)
    args = [t(x2_in_c1), valid, d, t(maxd2.astype(np.float32)), t(x1_in_c2),
            valid, d, t(maxd1.astype(np.float32)), t(feats(pts)), t(k), d,
            valid, t(feats(x2)), t(k), d, valid, fx, fy, cx, cy, w, h,
            t(np.asarray([1.2 ** i for i in range(8)], np.float32)),
            float(np.log(1.2)), 8]
    before = (mk.launches(), hk.launches(), hk.batched_launches())
    got = sm.match_by_sim3(*args)
    torch.cuda.synchronize()
    assert (mk.launches(), hk.launches(), hk.batched_launches()) == \
        (before[0] + 2, before[1], before[2])
    cuda_fn = mk.match_rows_cuda
    mk.match_rows_cuda = lambda *a, **kw: mk.match_rows_ref(*a[:10])
    try:
        want = sm.match_by_sim3(*args)
    finally:
        mk.match_rows_cuda = cuda_fn
    assert torch.equal(got.idx2_of_1, want.idx2_of_1)
    assert int(got.n_matches) == int(want.n_matches) > N // 4


# ------------------------------------------- the loop correction's solvers

def _reduced_system(cuda, C, P, E, seed=0):
    """A seeded reduced camera system as a global BA step hands its CG
    (tests/test_torch_loop_kernels.py's, at the card's sizes): the walks'
    rows of Wcp, Hpp^-1, Hcc_d, D^-1, cam_free (camera 0 fixed) and
    b_red; a tenth of the edges and 5% of the points invalid."""
    import airdos_tpu_torch.ops.ba_global as bg
    from airdos_tpu_torch.ops.segment_kernels import make_segments
    rng = np.random.default_rng(seed)
    e_cam = rng.integers(0, C, E)
    e_pt = rng.integers(0, P, E)
    pv = rng.random(P) > 0.05
    base = (rng.random(E) > 0.1) & pv[e_pt]
    wcp = rng.standard_normal((E, 6, 3)).astype(np.float32)
    A = rng.standard_normal((P, 3, 3)) * 0.05
    hinv = (A @ A.transpose(0, 2, 1) + 0.02 * np.eye(3)) * pv[:, None, None]
    B = rng.standard_normal((C, 6, 6))
    hcc = B @ B.transpose(0, 2, 1) + 400.0 * np.eye(6)
    cf = np.ones(C)
    cf[0] = 0.0
    dinv = np.linalg.inv(hcc)
    dinv[0] = np.eye(6)
    b = rng.standard_normal((C, 6)) * cf[:, None]

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda, dtype)

    ec, ep, keep = t(e_cam, torch.int64), t(e_pt, torch.int64), \
        t(base, torch.bool)
    wc = bg.make_walk(make_segments(ec, C, keep), ep)
    wp = bg.make_walk(make_segments(ep, P, keep), ec)
    W = t(wcp)
    return dict(w_p=bg.walk_rows(W, wp), w_c=bg.walk_rows(W, wc), wp=wp,
                wc=wc, hinv=t(hinv), hcc=t(hcc), dinv=t(dinv), cf=t(cf),
                b=t(b))


def _cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_cpu(y) for y in x))
    return x


@pytest.mark.parametrize("C,P,E", [(1000, 100_000, 300_000),
                                   (64, 6000, 20_000), (12, 300, 2000)])
def test_schur_kernels_equal_plain_versions(cuda, C, P, E):
    """schur_point and schur_camera at the map scale's and the pillar
    orbit's sizes: 48 CG iterations, each output and the CG state bit-equal
    to the plain versions on a CPU copy (their segment sums are
    index_add_ in walk order); raw modes bit-equal too; the last block
    leaves its counter at zero; one launch a call each."""
    import airdos_tpu_torch.ops.ba_global as bg
    s = _reduced_system(cuda, C, P, E)
    st = bg.cg_start(s["b"], s["dinv"])
    sc = _cpu(st)
    host = {k: _cpu(v) for k, v in s.items()}
    for _ in range(48):
        n0 = (bg.point_launches(), bg.camera_launches())
        z = bg.schur_point(s["w_p"], s["wp"], st.p, s["cf"], s["hinv"])
        zc = bg.schur_point(host["w_p"], host["wp"], sc.p, host["cf"],
                            host["hinv"])
        raw = bg.schur_point(s["w_p"], s["wp"], st.p, s["cf"], s["hinv"],
                             raw=True)
        rawc = bg.schur_point(host["w_p"], host["wp"], sc.p, host["cf"],
                              host["hinv"], raw=True)
        back = bg.schur_camera(s["w_c"], s["wc"], z, st, s["hcc"],
                               s["dinv"], s["cf"], raw=True)
        bg.schur_camera(s["w_c"], s["wc"], z, st, s["hcc"], s["dinv"],
                        s["cf"])
        backc = bg.schur_camera(host["w_c"], host["wc"], zc, sc, host["hcc"],
                                host["dinv"], host["cf"], raw=True)
        bg.schur_camera(host["w_c"], host["wc"], zc, sc, host["hcc"],
                        host["dinv"], host["cf"])
        torch.cuda.synchronize()
        assert (bg.point_launches(), bg.camera_launches()) == \
            (n0[0] + 2, n0[1] + 2)
        assert torch.equal(z.cpu(), zc) and torch.equal(raw.cpu(), rawc)
        assert torch.equal(back.cpu(), backc)
        for a, b in zip(st[:4], sc[:4]):
            assert torch.equal(a.cpu(), b)
        assert int(st.count) == 0
    assert torch.isfinite(st.x).all()


@pytest.mark.parametrize("K,E,regime", [(1000, 1000, "chain"),
                                        (64, 300, "chain"),
                                        (64, 300, "pi")])
def test_sim3_edges_kernel_within_tolerance_of_plain_version(cuda, K, E,
                                                              regime):
    """sim3_edges at the map scale's and the pillar orbit's sizes, in both
    modes: the cost within SYSTEM_RTOL of the plain version's (the
    residuals' torch.sum) on the card, the system held to the plain
    version in float64 (pose_graph_kernels.held: within each edge's
    tolerance, or twice the float32 plain version's gap), two
    launches bit-equal, one launch a call."""
    import airdos_tpu_torch.ops.pose_graph_kernels as pk
    from airdos_tpu_torch.geometry.se3 import so3_exp
    rng = np.random.default_rng(K + E)

    def rot(w):
        return so3_exp(torch.tensor(np.asarray(w), dtype=torch.float32))

    R = torch.stack([rot(rng.normal(0, 0.4, 3)) for _ in range(K)])
    t = torch.tensor(rng.normal(0, 2, (K, 3)), dtype=torch.float32)
    e_i = torch.tensor(rng.integers(0, K, E), dtype=torch.int32)
    e_j = torch.tensor((e_i.numpy() + rng.integers(1, K, E)) % K,
                       dtype=torch.int32)
    rel = R[e_j.long()] @ R[e_i.long()].transpose(1, 2)     # Rj Ri^T
    if regime == "pi":
        axis = np.array([0.6, 0.48, 0.64])
        Rm = torch.stack([rot(axis * (np.pi - d)) @ r for d, r in
                          zip(rng.uniform(1e-3, 3e-2, E), rel)])
    else:
        Rm = torch.stack([rot(rng.normal(0, 0.01, 3)) @ r for r in rel])
    tm = torch.tensor(rng.normal(0, 1, (E, 3)), dtype=torch.float32)
    w = torch.tensor(rng.random(E) > 0.05, dtype=torch.float32)
    args = [x.to(cuda).contiguous() for x in
            (R, t, torch.ones(K), e_i, e_j, Rm, tm, torch.ones(E), w)]
    for cost in (False, True):
        n0 = pk.launches()
        got = pk.sim3_edges(*args, cost)
        again = pk.sim3_edges(*args, cost)
        want = pk.sim3_edges_ref(*args, cost)
        torch.cuda.synchronize()
        assert pk.launches() == n0 + 2
        assert torch.equal(got, again) and torch.isfinite(got).all()
        if cost:
            assert float((got - want).abs()) <= \
                pk.SYSTEM_RTOL * float(want.abs())
        else:
            ok, mine, plain = pk.held(got, *args)
            assert ok, (mine, plain)


# ---------------------------- relocalization's and the loop's geometry

def _ransac_cases():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch_ransac_cases as trc
    return trc


def _on(arrays, dev, f64=False):
    out = []
    for a in arrays:
        t = torch.from_numpy(np.array(a)).to(dev)
        out.append(t.double() if f64 and t.dtype == torch.float32 else t)
    return out


@pytest.mark.parametrize("n,H,distinct", [(200, 256, True), (60, 256, False),
                                          (15, 64, False)])
def test_epnp_ransac_kernels_within_tolerance_of_plain_version(cuda, n, H,
                                                               distinct):
    import airdos_tpu_torch.ops.ransac_kernels as rk
    from airdos_tpu_torch.solvers import epnp as ep
    trc = _ransac_cases()
    case = trc.pnp_case(n, n=n, n_out=n // 5, H=H, distinct=distinct)
    pw, uv, valid, gate, smp = _on(case, cuda)
    cam = (trc.FX, trc.FY, trc.CX, trc.CY)
    got = rk.epnp_hypotheses_cuda(pw, uv, valid, gate, smp, *cam)
    again = rk.epnp_hypotheses_cuda(pw, uv, valid, gate, smp, *cam)
    plain = ep.epnp_hypotheses_ref(pw, uv, valid, gate, smp, *cam,
                                   canonical=True)
    other = ep.epnp_hypotheses_ref(pw, uv, valid, gate, smp, *cam,
                                   canonical=True, solve_dtype=torch.float32)
    p64, u64, _, g64, _ = _on(case, cuda, f64=True)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    held, stats = rk.hypotheses_held(got, plain, other, smp)
    assert held, stats
    best = torch.argmax(got[-1])
    args = (pw, uv, valid, gate, got[0][best], got[1][best], got[2][best],
            *cam)
    args64 = (p64, u64, valid, g64, got[0][best].double(),
              got[1][best].double(), got[2][best], *cam)
    held, stats = rk.refine_held(rk.epnp_refine_cuda(*args),
                                 ep.epnp_refine_ref(*args, canonical=True),
                                 ep.epnp_refine_ref(*args64, canonical=True))
    assert held, stats
    before = (rk.epnp_hypotheses_launches(), rk.epnp_refine_launches())
    res = ep.epnp_ransac(pw, uv, valid, gate, smp, *cam)
    torch.cuda.synchronize()
    assert (rk.epnp_hypotheses_launches(), rk.epnp_refine_launches()) == \
        (before[0] + 1, before[1] + 1)
    assert int(res.n_inliers) >= n - n // 5 - 3


@pytest.mark.parametrize("fix_scale", [True, False])
@pytest.mark.parametrize("n,distinct", [(150, True), (25, False)])
def test_horn_ransac_kernels_within_tolerance_of_plain_version(cuda, n,
                                                               distinct,
                                                               fix_scale):
    import airdos_tpu_torch.ops.ransac_kernels as rk
    from airdos_tpu_torch.solvers import sim3 as s3
    trc = _ransac_cases()
    case = trc.sim3_case(n, n=n, n_out=n // 5, H=256,
                         scale=1.0 if fix_scale else 1.3, distinct=distinct)
    x1, x2, valid, g1, g2, smp = _on(case, cuda)
    cam = (trc.FX, trc.FY, trc.CX, trc.CY)
    args = (x1, x2, valid, g1, g2, smp, *cam, fix_scale)
    got = rk.horn_hypotheses_cuda(*args)
    again = rk.horn_hypotheses_cuda(*args)
    plain = s3.sim3_hypotheses_ref(*args)
    a64 = _on(case, cuda, f64=True)
    plain64 = s3.sim3_hypotheses_ref(*a64[:5], smp, *cam, fix_scale)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    held, stats = rk.hypotheses_held(got, plain, plain64, smp)
    assert held, stats
    best = torch.argmax(got[-1])
    rargs = (x1, x2, valid, g1, g2, got[0][best], got[1][best], got[2][best],
             got[3][best], *cam, fix_scale)
    rargs64 = (*a64[:5], *(x.double() for x in rargs[5:8]), rargs[8],
               *cam, fix_scale)
    held, stats = rk.refine_held(rk.horn_refine_cuda(*rargs),
                                 s3.sim3_refine_ref(*rargs),
                                 s3.sim3_refine_ref(*rargs64))
    assert held, stats
    before = (rk.horn_hypotheses_launches(), rk.horn_refine_launches())
    s3.sim3_ransac(x1, x2, valid, smp, g1, g2, *cam, fix_scale=fix_scale)
    torch.cuda.synchronize()
    assert (rk.horn_hypotheses_launches(), rk.horn_refine_launches()) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("fix_scale", [True, False])
@pytest.mark.parametrize("n", [40, 300, 1200])
def test_sim3_opt_kernel_within_tolerance_of_plain_version(cuda, n,
                                                           fix_scale):
    import airdos_tpu_torch.ops.sim3_opt_kernels as so
    from airdos_tpu_torch.solvers.sim3 import optimize_sim3
    trc = _ransac_cases()
    case = _on(trc.opt_case(n, n=n, scale=1.0 if fix_scale else 1.1), cuda)
    args = (*case, trc.FX, trc.FY, trc.CX, trc.CY, 10.0, fix_scale, 10)
    got = so.sim3_opt_cuda(*args)
    again = so.sim3_opt_cuda(*args)
    want = so.optimize_sim3_ref(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    held, stats = so.held(got, want)
    assert held, stats
    before = so.launches()
    optimize_sim3(*args[:14], th2=10.0, fix_scale=fix_scale)
    torch.cuda.synchronize()
    assert so.launches() == before + 1


@pytest.mark.parametrize("k,depth,n", [(8, 3, 1500), (10, 4, 2000),
                                       (10, 6, 2000), (3, 1, 7)])
def test_voc_transform_kernel_bit_equal_to_plain_version(cuda, k, depth, n):
    import airdos_tpu_torch.ops.voc_kernels as vk
    from airdos_tpu_torch.bow.vocabulary import Vocabulary
    trc = _ransac_cases()
    children, desc, word_id = trc.full_tree(k * 10 + depth, k, depth)
    children[1, k // 2:] = -1               # a node with fewer children
    voc = Vocabulary(k=k, depth=depth, node_desc32=desc, children=children,
                     word_id=word_id, weights=np.ones(int((word_id >= 0)
                                                          .sum()), np.float32),
                     n_words=int((word_id >= 0).sum()), feature_level=2,
                     device="cuda")
    d = torch.from_numpy(trc.words(n, n).view(np.int32)).to(cuda)
    tables = voc._device_tables()
    before = vk.launches()
    got = vk.voc_transform(*tables, d, depth)
    again = vk.voc_transform(*tables, d, depth)
    torch.cuda.synchronize()
    assert vk.launches() == before + 2
    want = vk.voc_transform_ref(*tables, d, depth)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_ransac_and_voc_kernels_reject_what_they_do_not_take(cuda):
    import airdos_tpu_torch.ops.ransac_kernels as rk
    import airdos_tpu_torch.ops.voc_kernels as vk
    trc = _ransac_cases()
    pw, uv, valid, gate, smp = _on(trc.pnp_case(1, n=30, n_out=3, H=8),
                                   cuda)
    cam = (trc.FX, trc.FY, trc.CX, trc.CY)
    with pytest.raises(ValueError):
        rk.epnp_hypotheses_cuda(pw, uv, valid, gate, smp.long(), *cam)
    with pytest.raises(ValueError):
        rk.epnp_hypotheses_cuda(pw.double(), uv, valid, gate, smp, *cam)
    with pytest.raises(ValueError):
        rk.epnp_hypotheses_cuda(pw, uv[:, :1].contiguous(), valid, gate,
                                smp, *cam)
    with pytest.raises(ValueError):
        rk.epnp_refine_cuda(pw, uv, valid, gate, torch.eye(3, device=cuda),
                            torch.zeros(3, device=cuda), valid[:5], *cam)
    ch = torch.full((1, 20), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):          # k above the kernel's 16
        vk.voc_transform_cuda(ch, torch.zeros((1, 8), dtype=torch.int32,
                                              device=cuda),
                              ch[:, 0].contiguous(), ch[:, 0].contiguous(),
                              smp.reshape(-1)[:8].reshape(1, 8), 1)
