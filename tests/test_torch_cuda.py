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
