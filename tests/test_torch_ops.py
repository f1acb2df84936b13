"""The port's image ops and Hamming kernel module against airdos_tpu (CPU).

Inputs are made with numpy from a seed (or rendered by the synthetic
world) and handed to both packages.  Stated tolerances:
- FAST scores at level 0, NMS, erosion, pack_u32, Hamming distances: exact;
- blur, resize and pyramid levels: atol 1e-4 (float summation order);
- IC angles at level 0: atol 1e-3 degrees (on the integer-valued level-0
  image the moment sums are exact integers in float32; only atan2 may
  differ);
- ORB keypoints as sets per level: >= 99% common; descriptors of common
  keypoints >= 99% identical.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airdos_tpu.ops.brief as jbrief
import airdos_tpu.ops.fast as jfast
import airdos_tpu.ops.filters as jfilters
import airdos_tpu.ops.orientation as jori
import airdos_tpu.ops.pyramid as jpyr
from airdos_tpu.features.orb import OrbExtractor as JaxOrb
from airdos_tpu.io.synthetic import small_camera
from airdos_tpu.ops.pallas_kernels import (hamming_matrix_auto,
                                           hamming_matrix_pallas)
import airdos_tpu_torch.ops.brief as tbrief
import airdos_tpu_torch.ops.fast as tfast
import airdos_tpu_torch.ops.filters as tfilters
import airdos_tpu_torch.ops.hamming_kernels as hk
import airdos_tpu_torch.ops.orientation as tori
import airdos_tpu_torch.ops.pyramid as tpyr
from airdos_tpu_torch.features.orb import OrbExtractor as TorchOrb
from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one intra-op thread.  The suite runs in
    several pytest workers at once (ROADMAP's Tier-1 line: -n 6); with
    torch's default of an OpenMP thread per core in every worker, each
    parallel op waits on descheduled threads and a port System run slows
    down tens of times.  The other port test files import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def image():
    """A rendered 320x240 synthetic frame as the front end sees it: cast to
    uint8 on upload, then to float32."""
    world = SyntheticStereoWorld(seed=1, n_points=200, cam=small_camera())
    Rwc, twc = world.trajectory(1, 0.1)
    img = world.frame(0, Rwc[0], twc[0], 0.0).image_left
    return img.astype(np.uint8).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return np.asarray(x)


def _desc_u32(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def test_orb_pattern_is_byte_equal_to_jax_copy():
    a = (ROOT / "airdos_tpu" / "ops" / "orb_pattern.npy").read_bytes()
    b = (ROOT / "airdos_tpu_torch" / "ops" / "orb_pattern.npy").read_bytes()
    assert a == b


def test_gaussian_blur7_matches_jax(image):
    np.testing.assert_allclose(_n(tfilters.gaussian_blur7(_t(image))),
                               _n(jfilters.gaussian_blur7(jnp.asarray(image))),
                               atol=1e-4)


@pytest.mark.parametrize("out_hw", [(200, 267), (167, 222), (57, 91)])
def test_resize_bilinear_matches_jax(image, out_hw):
    np.testing.assert_allclose(
        _n(tfilters.resize_bilinear(_t(image), *out_hw)),
        _n(jfilters.resize_bilinear(jnp.asarray(image), *out_hw)), atol=1e-4)


def test_erode_matches_jax(rng):
    mask = (rng.uniform(size=(60, 80)) > 0.05).astype(np.float32)
    mask[20:30, 30:45] = 0.0
    np.testing.assert_array_equal(_n(tfilters.erode(_t(mask))),
                                  _n(jfilters.erode(jnp.asarray(mask))))


def test_pyramid_matches_jax(image, rng):
    mask = np.ones_like(image)
    mask[100:140, 150:200] = 0.0
    pt = tpyr.build_pyramid(_t(image), _t(mask), 4, 1.2)
    pj = jpyr.build_pyramid(jnp.asarray(image), jnp.asarray(mask), 4, 1.2)
    assert pt.scales == pj.scales
    for a, b in zip(pt.images, pj.images):
        np.testing.assert_allclose(_n(a), _n(b), atol=1e-4)
    for a, b in zip(pt.masks, pj.masks):
        np.testing.assert_array_equal(_n(a), _n(b))


def test_fast_scores_and_nms_exact_at_level0(image):
    st = tfast.fast_score_map(_t(image))
    sj = jfast.fast_score_map(jnp.asarray(image))
    np.testing.assert_array_equal(_n(st), _n(sj))
    assert (_n(st) > 7).sum() > 100
    thr_t = torch.where(st > 7, st, torch.zeros_like(st))
    np.testing.assert_array_equal(
        _n(tfast.nms_strict(thr_t)),
        _n(jfast.nms_strict(jnp.where(sj > 7, sj, 0.0))))


def _keypoints(rng, h, w, n=300):
    ys = rng.integers(16, h - 16, n)
    xs = rng.integers(16, w - 16, n)
    return xs, ys


def test_keypoint_angles_match_jax(image, rng):
    xs, ys = _keypoints(rng, *image.shape)
    at = tori.keypoint_angles(_t(image), _t(xs), _t(ys))
    aj = jori.keypoint_angles(jnp.asarray(image), jnp.asarray(xs, jnp.int32),
                              jnp.asarray(ys, jnp.int32))
    diff = np.abs(_n(at) - _n(aj))
    diff = np.minimum(diff, 360.0 - diff)
    assert diff.max() < 1e-3, diff.max()


def test_brief_descriptors_match_jax(image, rng):
    blurred = _n(jfilters.gaussian_blur7(jnp.asarray(image)))
    xs, ys = _keypoints(rng, *image.shape)
    ang = rng.uniform(0, 360, xs.shape).astype(np.float32)
    dt = tbrief.compute_descriptors(_t(blurred), _t(xs), _t(ys), _t(ang))
    dj = jbrief.compute_descriptors(jnp.asarray(blurred),
                                    jnp.asarray(xs, jnp.int32),
                                    jnp.asarray(ys, jnp.int32),
                                    jnp.asarray(ang))
    rows_equal = np.all(_n(dt) == _n(dj), axis=1)
    assert rows_equal.mean() >= 0.99, rows_equal.mean()


def test_pack_u32_exact(rng):
    d = rng.integers(0, 256, (50, 32)).astype(np.uint8)
    packed = tbrief.pack_u32(_t(d))
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(_n(packed).view(np.uint32),
                                  _n(jbrief.pack_u32(jnp.asarray(d))))


@pytest.mark.parametrize("n,m", [(256, 128), (128, 384)])
def test_hamming_matches_pallas_kernel_interpreted(rng, n, m):
    a, b = _desc_u32(rng, n), _desc_u32(rng, m)
    want = _n(hamming_matrix_pallas(jnp.asarray(a.T), jnp.asarray(b.T),
                                    interpret=True))
    got = hk.hamming_matrix_ref(_t(a.view(np.int32)), _t(b.view(np.int32)))
    np.testing.assert_array_equal(_n(got), want)


@pytest.mark.parametrize("n,m", [(200, 77), (1, 5), (33, 1)])
def test_hamming_matches_jax_on_ragged_shapes(rng, n, m):
    a, b = _desc_u32(rng, n), _desc_u32(rng, m)
    want = _n(hamming_matrix_auto(jnp.asarray(a), jnp.asarray(b)))
    got = hk.hamming_matrix(_t(a.view(np.int32)), _t(b.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_n(got), want)


def _special_words(rng, kind, n):
    if kind == "zeros":
        return np.zeros((n, 8), np.uint32)
    if kind == "ones":
        return np.full((n, 8), 0xFFFFFFFF, np.uint32)
    w = _desc_u32(rng, n)
    if kind == "sign":                    # negative as int32 bit views
        w |= np.uint32(0x80000000)
    return w


@pytest.mark.parametrize("kind_a,kind_b", [
    ("zeros", "zeros"), ("ones", "ones"), ("ones", "zeros"),
    ("sign", "ones"), ("sign", "sign"), ("random", "random")])
def test_and_popcount_identity_matches_xor_popcount(rng, kind_a, kind_b):
    """popc(a) + popc(b) - 2 popc(a & b) == popc(a ^ b): the arithmetic of
    the binary tensor-core kernel, in plain torch, against the XOR form,
    on int32 bit views with the sign bit set, all-ones and all-zeros
    words and random words (each side also holds random rows)."""
    a = np.concatenate([_special_words(rng, kind_a, 40), _desc_u32(rng, 9)])
    b = np.concatenate([_special_words(rng, kind_b, 33), _desc_u32(rng, 7)])
    ta, tb = _t(a.view(np.int32)), _t(b.view(np.int32))
    got = hk.hamming_matrix_and_popc(ta, tb)
    assert got.dtype == torch.int32 and got.shape == (49, 40)
    want = hk.hamming_matrix_ref(ta, tb)
    assert torch.equal(got, want)
    # against numpy's XOR popcount on the uint32 words
    x = a[:, None, :] ^ b[None, :, :]
    bits = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
    np.testing.assert_array_equal(_n(got), bits)


def test_hamming_cpu_tensors_take_the_plain_version(rng):
    a = _t(_desc_u32(rng, 64).view(np.int32))
    hk.reset_launches()
    out = hk.hamming_matrix(a, a)
    assert hk.launches() == 0
    assert (torch.diagonal(out) == 0).all()
    with pytest.raises(ValueError):
        hk.hamming_matrix_cuda(a, a)


def _per_level_sets(xy, octave, valid, n_levels):
    out = []
    for lvl in range(n_levels):
        sel = valid & (octave == lvl)
        out.append({(round(float(x), 3), round(float(y), 3)): i
                    for i, (x, y) in zip(np.nonzero(sel)[0], xy[sel])})
    return out


def test_orb_extractor_matches_jax(image):
    n_levels = 4
    ft = TorchOrb(600, 1.2, n_levels)._extract_from_pyramid(
        tpyr.build_pyramid(_t(image), None, n_levels, 1.2))
    fj = JaxOrb(600, 1.2, n_levels)(jnp.asarray(image))
    assert ft.xy.shape == fj.xy.shape and ft.xy.shape[0] % 128 == 0
    sets_t = _per_level_sets(_n(ft.xy), _n(ft.octave), _n(ft.valid), n_levels)
    sets_j = _per_level_sets(_n(fj.xy), _n(fj.octave), _n(fj.valid), n_levels)
    d_t, d_j = _n(ft.desc), _n(fj.desc)
    n_same_desc = n_common = 0
    for st, sj in zip(sets_t, sets_j):
        common = set(st) & set(sj)
        assert len(common) >= 0.99 * max(len(st), len(sj)), (len(st), len(sj))
        n_common += len(common)
        n_same_desc += sum(np.array_equal(d_t[st[k]], d_j[sj[k]])
                           for k in common)
    assert n_common > 300
    assert n_same_desc >= 0.99 * n_common
