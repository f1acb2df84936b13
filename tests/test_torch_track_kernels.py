"""The tracking frame's three kernel modules against airdos_tpu (CPU).

The pose LM (solvers/pose_opt.py, csrc/pose_lm.cu), the FAST detection map
(ops/fast.py fast_nms, csrc/fast.cu) and the IC angle with rBRIEF
(ops/orb_kernels.py, csrc/orb_desc.cu) run here through their
dispatchers on CPU tensors, that is through the shared packing and the
plain versions; the kernels themselves run in tests/test_torch_cuda.py
and chip_smoke.py on the card.  Inputs are made with numpy from a seed
and handed to both packages.  Stated tolerances:
- pose_optimize: rotation within 1e-4 (Frobenius), translation within
  1e-4 m, inlier flags >= 99% equal (tests/test_torch_pose.py's);
- the FAST detection map: exact, against airdos_tpu's fast_score_map ->
  mask -> interior -> threshold -> nms_strict;
- angles: on the integer-valued level 0, within 1e-3 degrees of
  airdos_tpu's CPU lowering (_angles_gather; test_torch_ops.py's: the
  moment sums are exact there, only atan2 may differ); on every level
  within 1e-4 degrees of the angle of the exact moments (float64 numpy)
  and within 0.1 degrees of _angles_gather, whose float32 moment sums
  round on the interpolated levels (the tolerance airdos_tpu's own
  tests/test_frontend.py holds its two lowerings to);
- descriptor words: exact against airdos_tpu's compute_descriptors
  (_samples_gather) at the same angles, on the keypoints none of whose
  rotated samples lies within 1e-4 px of a rounding tie (where the two
  packages' cos and sin may round to either side);
- the whole masked extractor: keypoint sets per level >= 99% common,
  descriptors of common keypoints >= 99% identical (test_torch_ops.py's),
  angles as above.
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airdos_tpu.geometry.se3 as jse3
import airdos_tpu.ops.fast as jfast
import airdos_tpu.ops.filters as jfilters
from airdos_tpu.features.orb import OrbExtractor as JaxOrb
from airdos_tpu.ops.brief import _samples_gather, compute_descriptors
from airdos_tpu.ops.orientation import _angles_gather
from airdos_tpu.solvers.pose_opt import pose_optimize as jax_pose_optimize
import airdos_tpu_torch.ops.fast as tfast
import airdos_tpu_torch.ops.orb_kernels as tok
import airdos_tpu_torch.ops.pyramid as tpyr
import airdos_tpu_torch.solvers.pose_opt as tpo
from airdos_tpu_torch.features.orb import MIN_BORDER
from airdos_tpu_torch.features.orb import OrbExtractor as TorchOrb
from airdos_tpu_torch.ops.brief import load_pattern
from airdos_tpu_torch.ops.orientation import _moment_kernels, _umax
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

CSRC = Path(__file__).resolve().parents[1] / "airdos_tpu_torch" / "csrc"


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return np.asarray(x)


# ---------------------------------------------------------------- pose LM

def _pose_problem(rng, n, n_mono, invalid_frac, behind_frac):
    fx = fy = 500.0
    cx, cy, bf = 320.0, 180.0, 250.0
    xw = rng.uniform([-5, -3, 4], [5, 3, 25], (n, 3)).astype(np.float32)
    xi_gt = np.array([0.1, -0.05, 0.2, 0.02, -0.03, 0.01], np.float32)
    Rgt, tgt = (np.asarray(a, np.float64)
                for a in jse3.se3_exp(jnp.asarray(xi_gt)))
    xc = xw @ Rgt.T + tgt
    z = xc[:, 2]
    u = fx * xc[:, 0] / z + cx
    v = fy * xc[:, 1] / z + cy
    obs = np.stack([u, v, u - bf / z], axis=1).astype(np.float32)
    obs[:, :2] += rng.normal(0, 0.3, (n, 2))
    n_out = n // 10
    out_idx = rng.choice(n, n_out, replace=False)
    obs[out_idx, :2] += rng.uniform(20, 60, (n_out, 2)) * \
        rng.choice([-1, 1], (n_out, 2))
    obs[:n_mono, 2] = -1.0
    # points mirrored behind the camera (their observations kept)
    n_behind = int(n * behind_frac)
    if n_behind:
        idx = rng.choice(n, n_behind, replace=False)
        xw[idx, 2] = -xw[idx, 2]
    inv_sigma2 = (1.0 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.uniform(size=n) >= invalid_frac
    xi0 = xi_gt + np.array([0.05, 0.05, -0.08, 0.01, 0.02, -0.015],
                           np.float32)
    return xi0, xw, obs, inv_sigma2, valid, (fx, fy, cx, cy, bf)


# airdos_tpu's pose LM under one jit (as its fused step runs it): one
# compile a shape, where its eager calls trace every round's loop anew
_jax_pose = jax.jit(jax_pose_optimize)

# (n, mono edges, share invalid, share behind the camera, prior weights);
# the kernel's block is 512 threads
_POSE_CASES = {
    "mixed": (777, 77, 0.05, 0.0, (0.0, 0.0)),
    "mixed, prior": (777, 77, 0.05, 0.0, (400.0, 400.0)),
    "all mono": (777, 777, 0.05, 0.0, (0.0, 0.0)),
    "all mono, prior": (777, 777, 0.05, 0.0, (400.0, 100.0)),
    "invalid rows": (777, 50, 0.4, 0.0, (0.0, 0.0)),
    "behind the camera": (777, 40, 0.05, 0.15, (400.0, 400.0)),
    "N above twice the block": (1031, 0, 0.1, 0.05, (400.0, 400.0)),
}


@pytest.mark.parametrize("case", list(_POSE_CASES))
def test_pose_optimize_matches_jax(rng, case):
    n, n_mono, invalid, behind, prior = _POSE_CASES[case]
    xi0, xw, obs, isig, valid, cam = _pose_problem(rng, n, n_mono, invalid,
                                                   behind)
    R0, t0 = jse3.se3_exp(jnp.asarray(xi0))
    ref = _jax_pose(R0, t0, jnp.asarray(xw), jnp.asarray(obs),
                    jnp.asarray(isig), jnp.asarray(valid), *cam,
                    prior_w_rot=prior[0], prior_w_trans=prior[1])
    before = tpo.launches()
    got = tpo.pose_optimize(_t(np.asarray(R0)), _t(np.asarray(t0)), _t(xw),
                            _t(obs), _t(isig), _t(valid), *cam,
                            prior_w_rot=prior[0], prior_w_trans=prior[1])
    assert tpo.launches() == before          # CPU tensors: the plain version
    assert np.linalg.norm(got.R.numpy() - np.asarray(ref.R)) < 1e-4
    assert np.abs(got.t.numpy() - np.asarray(ref.t)).max() < 1e-4
    inl_ref = np.asarray(ref.inlier)
    assert np.mean(got.inlier.numpy() == inl_ref) >= 0.99
    assert int(got.n_inliers) == int(got.inlier.sum())
    assert got.n_inliers.dtype == torch.int64
    assert inl_ref.sum() > 0.5 * valid.sum()
    assert not got.inlier.numpy()[~valid].any()


def test_pose_optimize_with_every_edge_invalid_keeps_the_pose(rng):
    xi0, xw, obs, isig, _, cam = _pose_problem(rng, 777, 20, 0.0, 0.0)
    valid = np.zeros(777, bool)
    R0, t0 = jse3.se3_exp(jnp.asarray(xi0))
    ref = _jax_pose(R0, t0, jnp.asarray(xw), jnp.asarray(obs),
                    jnp.asarray(isig), jnp.asarray(valid), *cam)
    got = tpo.pose_optimize(_t(np.asarray(R0)), _t(np.asarray(t0)), _t(xw),
                            _t(obs), _t(isig), _t(valid), *cam)
    np.testing.assert_array_equal(got.R.numpy(), np.asarray(R0))
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(t0))
    np.testing.assert_allclose(np.asarray(ref.R), np.asarray(R0), atol=1e-6)
    assert int(got.n_inliers) == 0 and not got.inlier.any()


def test_pack_problem_is_what_the_plain_version_reads(rng):
    xi0, xw, obs, isig, valid, cam = _pose_problem(rng, 33, 5, 0.2, 0.0)
    R0, t0 = (np.asarray(a) for a in jse3.se3_exp(jnp.asarray(xi0)))
    prob = tpo.pack_problem(_t(R0), _t(t0), _t(xw), _t(obs), _t(isig),
                            _t(valid), *cam, 2.447749, 2.795483, 0.1, 1e-50)
    assert prob.edges.dtype == torch.float32 and prob.edges.shape == (33, 8)
    assert prob.edges.is_contiguous() and prob.pose0.shape == (12,)
    np.testing.assert_array_equal(prob.pose0.numpy(),
                                  np.concatenate([R0.ravel(), t0]))
    np.testing.assert_array_equal(prob.edges[:, :3].numpy(), xw)
    np.testing.assert_array_equal(prob.edges[:, 3:6].numpy(), obs)
    np.testing.assert_array_equal(prob.edges[:, 6].numpy(), isig)
    np.testing.assert_array_equal(prob.edges[:, 7].numpy() > 0, valid)
    # the scalars as float32 values: a weight below float32's range is 0,
    # for the plain version as for the kernel
    assert prob.scalars[:5] == tuple(float(np.float32(c)) for c in cam)
    assert prob.scalars[7] == float(np.float32(0.1)) and prob.scalars[8] == 0.0


def test_pose_lm_cuda_raises_on_cpu_tensors(rng):
    xi0, xw, obs, isig, valid, cam = _pose_problem(rng, 64, 0, 0.0, 0.0)
    R0, t0 = (np.asarray(a) for a in jse3.se3_exp(jnp.asarray(xi0)))
    prob = tpo.pack_problem(_t(R0), _t(t0), _t(xw), _t(obs), _t(isig),
                            _t(valid), *cam, 2.447749, 2.795483, 0.0, 0.0)
    with pytest.raises(ValueError):
        tpo.pose_lm_cuda(*prob)


# ------------------------------------------------------------------ FAST

@pytest.fixture(scope="module")
def frame():
    """A 320x240 texture from numpy (uniform noise under two box blurs,
    quantized to uint8 as the front end uploads it) and a mask with a
    blanked person-sized box."""
    rng = np.random.default_rng(11)
    img = rng.uniform(0, 255, (240 + 8, 320 + 8))
    for _ in range(2):
        img = sum(img[dy:dy + img.shape[0] - 4, dx:dx + img.shape[1] - 4]
                  for dy in range(5) for dx in range(5)) / 25.0
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    mask = np.ones((240, 320), np.float32)
    mask[60:200, 120:190] = 0.0
    return np.round(img).astype(np.uint8).astype(np.float32), mask


@pytest.fixture(scope="module")
def pyramid(frame):
    """The port's 8-level pyramid of the frame and its mask, as numpy:
    both packages get these levels."""
    img, mask = frame
    pyr = tpyr.build_pyramid(_t(img), _t(mask), 8, 1.2)
    return [_n(a) for a in pyr.images], [_n(m) for m in pyr.masks]


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_detection_map(im, m, min_th, border):
    """airdos_tpu/features/orb.py's composition, NMS included."""
    h, w = im.shape
    score = jfast.fast_score_map(im) * m
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inside = ((yy >= border) & (yy < h - border) &
              (xx >= border) & (xx < w - border))
    score = jnp.where(inside, score, 0.0)
    return jfast.nms_strict(jnp.where(score > min_th, score, 0.0))


@pytest.mark.parametrize("level", [0, 2, 5, 7])
@pytest.mark.parametrize("masked", [False, True])
def test_fast_nms_matches_jax_exactly(pyramid, level, masked):
    images, masks = pyramid
    im = images[level]
    m = masks[level] if masked else np.ones_like(im)
    want = _n(_jax_detection_map(im, m, 7.0, MIN_BORDER))
    before = tfast.launches()
    got = tfast.fast_nms(_t(im), _t(m), 7.0, MIN_BORDER)
    assert tfast.launches() == before
    np.testing.assert_array_equal(_n(got), want)
    assert (want > 0).sum() > (5 if level < 7 else 0)
    if masked:
        assert (_n(got)[m == 0] == 0).all()


@pytest.mark.parametrize("shape", [(40, 40), (33, 70), (20, 50)])
def test_fast_nms_on_levels_at_most_twice_the_border(rng, shape):
    """Levels whose interior is a few pixels or empty: the plain version's
    wrapping rolls read only the zeroed frame."""
    im = rng.integers(0, 256, shape).astype(np.float32)
    m = np.ones(shape, np.float32)
    got = tfast.fast_nms(_t(im), _t(m), 7.0, MIN_BORDER)
    np.testing.assert_array_equal(
        _n(got), _n(_jax_detection_map(im, m, 7.0, MIN_BORDER)))


def _cuda_table(source, name):
    text = (CSRC / source).read_text()
    body = re.search(name + r"\[[^\]]*\]\s*=\s*\{([^}]*)\}", text).group(1)
    return [int(v) for v in body.replace("\n", " ").split(",") if v.strip()]


def test_fast_kernel_circle_is_opencvs():
    assert _cuda_table("fast.cu", "kCircleDx") == tfast.CIRCLE[:, 0].tolist()
    assert _cuda_table("fast.cu", "kCircleDy") == tfast.CIRCLE[:, 1].tolist()
    np.testing.assert_array_equal(tfast.CIRCLE, jfast.CIRCLE)


def test_fast_nms_cuda_raises_on_cpu_tensors():
    im = torch.zeros((64, 64))
    with pytest.raises(ValueError):
        tfast.fast_nms_cuda(im, im, 7.0, MIN_BORDER)


# ------------------------------------------------- IC angle and rBRIEF

def test_orb_kernel_disc_is_the_reference_umax():
    assert _cuda_table("orb_desc.cu", "kUmax") == _umax().tolist()


def test_pattern_points_are_compute_descriptors_points():
    pat = load_pattern()
    pts = tok.pattern_points("cpu").numpy()
    assert pts.shape == (2, 512) and pts.dtype == np.float32
    np.testing.assert_array_equal(pts[0], np.concatenate([pat[:, 0], pat[:, 2]]))
    np.testing.assert_array_equal(pts[1], np.concatenate([pat[:, 1], pat[:, 3]]))


def _keypoints(rng, h, w, n):
    xs = np.concatenate([rng.integers(MIN_BORDER, w - MIN_BORDER, n - 4),
                         [MIN_BORDER, w - MIN_BORDER - 1] * 2])
    ys = np.concatenate([rng.integers(MIN_BORDER, h - MIN_BORDER, n - 4),
                         [MIN_BORDER] * 2 + [h - MIN_BORDER - 1] * 2])
    return xs.astype(np.int64), ys.astype(np.int64)


def _far_from_ties(angles_deg, margin=1e-4):
    """Keypoints none of whose 512 rotated samples lies within margin px
    of a .5 rounding tie (float64 rotation)."""
    pat = load_pattern().astype(np.float64)
    px = np.concatenate([pat[:, 0], pat[:, 2]])
    py = np.concatenate([pat[:, 1], pat[:, 3]])
    a = np.deg2rad(angles_deg.astype(np.float64))[:, None]
    rx = px * np.cos(a) - py * np.sin(a)
    ry = px * np.sin(a) + py * np.cos(a)
    near = lambda r: np.abs(np.abs(r - np.floor(r)) - 0.5) < margin  # noqa: E731
    return ~(near(rx) | near(ry)).any(axis=1)


def _exact_angles(im, xs, ys):
    """The IC angles (degrees) of the exact moments, in float64 numpy."""
    h, w = im.shape
    d = np.arange(-15, 16)
    gy = np.clip(ys[:, None] + d, 0, h - 1)
    gx = np.clip(xs[:, None] + d, 0, w - 1)
    patch = im[gy[:, :, None], gx[:, None, :]].astype(np.float64)
    m = np.einsum("nij,kij->nk", patch, _moment_kernels().astype(np.float64))
    return np.degrees(np.arctan2(m[:, 1], m[:, 0])) % 360.0


def _angle_gap(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) % 360.0
    return np.minimum(d, 360.0 - d)


@jax.jit
def _jax_words(blur, xs, ys, ang):
    """airdos_tpu's descriptors (CPU: the gather lowering) as int32 bit
    views of pack_u32's words."""
    desc = compute_descriptors(blur, xs, ys, ang)
    return jax.lax.bitcast_convert_type(desc.reshape(-1, 8, 4), jnp.int32)


@pytest.mark.parametrize("level", [0, 2, 5])
def test_orb_describe_matches_jax(pyramid, rng, level):
    images, _ = pyramid
    im = images[level]
    h, w = im.shape
    blur = _n(jfilters.gaussian_blur7(jnp.asarray(im)))
    xs, ys = _keypoints(rng, h, w, 120)
    before = tok.launches()
    ang, words = tok.orb_describe(_t(im), _t(blur), _t(xs), _t(ys))
    assert tok.launches() == before
    assert ang.dtype == torch.float32 and words.dtype == torch.int32
    assert words.shape == (120, 8)

    xs_j, ys_j = jnp.asarray(xs, jnp.int32), jnp.asarray(ys, jnp.int32)
    ang_j = _n(jax.jit(_angles_gather)(jnp.asarray(im), xs_j, ys_j))
    assert _angle_gap(ang, _exact_angles(im, xs, ys)).max() < 1e-4
    assert _angle_gap(ang, ang_j).max() < (1e-3 if level == 0 else 0.1)

    want = _n(_jax_words(jnp.asarray(blur), xs_j, ys_j, jnp.asarray(_n(ang))))
    far = _far_from_ties(_n(ang))
    assert far.mean() > 0.5, far.mean()
    np.testing.assert_array_equal(_n(words)[far], want[far])


def test_orb_describe_levels_matches_jax(pyramid, rng):
    """All 8 levels in one dispatcher call (a level with no keypoint among
    them): each level's angles and descriptors against airdos_tpu's."""
    images, _ = pyramid
    quotas = (60, 45, 0, 30, 24, 20, 16, 12)
    blurs, xs, ys = [], [], []
    for im, q in zip(images, quotas):
        h, w = im.shape
        blurs.append(_n(jfilters.gaussian_blur7(jnp.asarray(im))))
        x, y = _keypoints(rng, h, w, max(q, 4))
        xs.append(x[:q])
        ys.append(y[:q])
    before = tok.launches()
    ang, words = tok.orb_describe_levels([_t(im) for im in images],
                                         [_t(b) for b in blurs],
                                         _t(np.concatenate(xs)),
                                         _t(np.concatenate(ys)), quotas)
    assert tok.launches() == before
    assert ang.shape == (sum(quotas),) and words.shape == (sum(quotas), 8)
    n_far = 0
    for lvl, (im, blur, x, y, f) in enumerate(zip(
            images, blurs, xs, ys, tok.level_table(quotas))):
        if not len(x):
            continue
        a = _n(ang)[f:f + len(x)]
        xs_j, ys_j = jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32)
        ang_j = _n(jax.jit(_angles_gather)(jnp.asarray(im), xs_j, ys_j))
        assert _angle_gap(a, _exact_angles(im, x, y)).max() < 1e-4
        assert _angle_gap(a, ang_j).max() < (1e-3 if lvl == 0 else 0.1)
        want = _n(_jax_words(jnp.asarray(blur), xs_j, ys_j, jnp.asarray(a)))
        far = _far_from_ties(a)
        n_far += int(far.sum())
        np.testing.assert_array_equal(_n(words)[f:f + len(x)][far], want[far])
    assert n_far > 0.5 * sum(quotas)


def test_orb_describe_cuda_raises_on_cpu_tensors():
    im = torch.zeros((64, 64))
    xs = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        tok.orb_describe_cuda(im, im, xs, xs)


# -------------------------------------------------------- the extractor

def _per_level(feats, n_levels):
    xy, octave = _n(feats.xy), _n(feats.octave)
    valid = _n(feats.valid)
    out = []
    for lvl in range(n_levels):
        sel = np.nonzero(valid & (octave == lvl))[0]
        out.append({(round(float(xy[i, 0]), 3), round(float(xy[i, 1]), 3)): i
                    for i in sel})
    return out


def test_masked_extractor_matches_jax(frame):
    """The human path's masked extraction at all 8 levels through the
    dispatchers: keypoints, angles and descriptors against airdos_tpu."""
    img, mask = frame
    n_levels = 8
    ft = TorchOrb(1000, 1.2, n_levels)._extract_from_pyramid(
        tpyr.build_pyramid(_t(img), _t(mask), n_levels, 1.2))
    fj = JaxOrb(1000, 1.2, n_levels)(jnp.asarray(img), jnp.asarray(mask))
    assert ft.xy.shape == fj.xy.shape
    np.testing.assert_array_equal(_n(ft.desc32).view(np.uint8).reshape(-1, 32),
                                  _n(ft.desc))
    sets_t, sets_j = _per_level(ft, n_levels), _per_level(fj, n_levels)
    ang_t, ang_j = _n(ft.angle), _n(fj.angle)
    d_t, d_j = _n(ft.desc), _n(fj.desc)
    n_common = n_same = 0
    for lvl, (st, sj) in enumerate(zip(sets_t, sets_j)):
        common = sorted(set(st) & set(sj))
        assert len(common) >= 0.99 * max(len(st), len(sj)), (len(st), len(sj))
        n_common += len(common)
        it = [st[k] for k in common]
        ij = [sj[k] for k in common]
        assert _angle_gap(ang_t[it], ang_j[ij]).max(initial=0.0) < \
            (1e-3 if lvl == 0 else 0.1)
        n_same += int(np.all(d_t[it] == d_j[ij], axis=1).sum())
    assert n_common > 200
    assert n_same >= 0.99 * n_common
    # nothing detected where the eroded mask is 0 at level 0
    xy0 = _n(ft.xy)[_n(ft.valid) & (_n(ft.octave) == 0)].astype(int)
    assert (mask[xy0[:, 1], xy0[:, 0]] == 1).all()
