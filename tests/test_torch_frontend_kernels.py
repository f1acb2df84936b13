"""The ORB front end's four kernel modules against airdos_tpu (CPU).

The pyramid with its masks and blurs (ops/pyramid.py, csrc/pyramid.cu),
keypoint selection (ops/select.py, csrc/select.cu), the stereo SAD
refinement (ops/stereo_sad.py, csrc/stereo_sad.cu) and the torso-probe
disparity (ops/disparity.py, csrc/disparity.cu) run here through their
dispatchers on CPU tensors, that is through their plain versions; the
kernels themselves run in tests/test_torch_cuda.py and chip_smoke.py on
the card.  Inputs are made with numpy from a seed, or rendered by the
synthetic world, and handed to both packages.  Stated tolerances:
- the pyramid: images and blurs within 1e-4 of airdos_tpu's
  build_pyramid and gaussian_blur7 run op by op (tests/test_torch_ops.py's
  tolerance; under jit XLA may contract the source coordinate's (d + 0.5)
  * s - 0.5 into a multiply-add, which moves a bilinear value by an ulp
  of the coordinate times its neighbours' difference, 2.6e-4 on this
  texture), masks exact;
- selection: exact against airdos_tpu's _select_level_keypoints;
- the front end as a whole on a rendered crowd frame (masked pyramid,
  extraction, stereo, disparity) against airdos_tpu's FrontEnd: keypoint
  slots >= 99% equal, stereo best_right >= 99% equal and u_right within
  1e-3 px where both accept (tests/test_torch_matching.py's), the
  torso-probe disparity exact.
"""
import functools
import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airdos_tpu.ops.fast as jfast
import airdos_tpu.ops.filters as jfilters
import airdos_tpu.ops.pyramid as jpyr
import airdos_tpu_torch.ops.disparity as tdisp
import airdos_tpu_torch.ops.fast as tfast
import airdos_tpu_torch.ops.pyramid as tpyr
import airdos_tpu_torch.ops.select as tsel
import airdos_tpu_torch.ops.stereo_sad as tsad
from airdos_tpu.config import SlamConfig as JaxConfig
from airdos_tpu.features.orb import _select_level_keypoints
from airdos_tpu.io.synthetic import SyntheticStereoWorld, small_camera
from airdos_tpu.ops.disparity import patch_disparity as jax_patch_disparity
from airdos_tpu.slam.frame import FrontEnd as JaxFrontEnd
from airdos_tpu.slam.frame import torso_pixels
from airdos_tpu_torch.config import SlamConfig as TorchConfig
from airdos_tpu_torch.features.orb import (MIN_BORDER, _cell_size_for,
                                           level_quotas)
from airdos_tpu_torch.slam.frame import FrontEnd as TorchFrontEnd
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

CSRC = Path(__file__).resolve().parents[1] / "airdos_tpu_torch" / "csrc"
N_LEVELS = 4
INI_TH, MIN_TH = 12.0, 7.0
COUNTERS = (tpyr, tsel, tsad, tdisp)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return np.asarray(x)


def _launches():
    return [m.launches() for m in COUNTERS]


@pytest.fixture(scope="module")
def frame():
    """A 160x120 texture from numpy (uniform noise under two box blurs,
    quantized to uint8 as the front end uploads it) and a usable-pixel
    mask with a blanked person-sized box."""
    rng = np.random.default_rng(21)
    img = rng.uniform(0, 255, (120 + 8, 160 + 8))
    for _ in range(2):
        img = sum(img[dy:dy + img.shape[0] - 4, dx:dx + img.shape[1] - 4]
                  for dy in range(5) for dx in range(5)) / 25.0
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    mask = np.ones((120, 160), np.uint8)
    mask[30:100, 60:95] = 0
    return np.round(img).astype(np.float32), mask


# -------------------------------------------------------------- pyramid

def _jax_pyramid(im, m):
    """airdos_tpu's pyramid of an image and its float32 mask, and the blur
    of each level, op by op."""
    pyr = jpyr.build_pyramid(im, m, N_LEVELS, 1.2)
    return pyr.images, pyr.masks, [jfilters.gaussian_blur7(x)
                                   for x in pyr.images]


@pytest.mark.parametrize("mask_kind", [None, "uint8", "float32"])
def test_build_pyramid_matches_jax(frame, mask_kind):
    img, mask = frame
    jmask = mask.astype(np.float32) if mask_kind else np.ones_like(img)
    want = [[_n(x) for x in part] for part in
            _jax_pyramid(jnp.asarray(img), jnp.asarray(jmask))]
    tmask = None if mask_kind is None else _t(mask.astype(mask_kind))
    before = _launches()
    got = tpyr.build_pyramid(_t(img), tmask, N_LEVELS, 1.2)
    assert _launches() == before
    assert len(got.blurred) == N_LEVELS
    assert got.scales == tuple(1.2 ** lvl for lvl in range(N_LEVELS))
    for lvl in range(N_LEVELS):
        np.testing.assert_allclose(_n(got.images[lvl]), want[0][lvl],
                                   atol=1e-4)
        np.testing.assert_array_equal(_n(got.masks[lvl]), want[1][lvl])
        np.testing.assert_allclose(_n(got.blurred[lvl]), want[2][lvl],
                                   atol=1e-4)
    if mask_kind:
        assert 0 < _n(got.masks[1]).sum() < got.masks[1].numel()


def test_pyramid_levels_are_the_composed_filters(frame):
    """Each level is resize_bilinear of the level before, its mask that
    resize > 0.999, its blur gaussian_blur7: the plain version the kernel
    is held to bit for bit."""
    from airdos_tpu_torch.ops.filters import (erode, gaussian_blur7,
                                              resize_bilinear)
    img, mask = frame
    got = tpyr.build_pyramid(_t(img), _t(mask), N_LEVELS, 1.2)
    assert torch.equal(got.masks[0], erode(_t(mask).float(), 10))
    for lvl in range(1, N_LEVELS):
        h, w = got.images[lvl].shape
        assert torch.equal(got.images[lvl],
                           resize_bilinear(got.images[lvl - 1], h, w))
        assert torch.equal(got.masks[lvl], (resize_bilinear(
            got.masks[lvl - 1], h, w) > 0.999).float())
    for im, bl in zip(got.images, got.blurred):
        assert torch.equal(bl, gaussian_blur7(im))


def test_pyramid_kernel_taps_and_windows_are_the_plain_versions():
    """The constants csrc/pyramid.cu holds: the erosion's k x k window
    (10 by default, at most MAX_ERODE) anchored at (k / 2, k / 2), cv2's
    anchor as ops/filters.erode pads it, and the blur's 7 taps and 3 px
    halo."""
    text = (CSRC / "pyramid.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert (consts["kMaxErode"], consts["kHalo"]) == \
        (str(tpyr.MAX_ERODE), "3")
    assert "const int erode_lo = erode_k / 2;" in text
    assert inspect.signature(tpyr.build_pyramid) \
        .parameters["mask_erode"].default == 10
    assert len(tpyr._TAPS) == 7
    np.testing.assert_array_equal(
        np.frombuffer(bytes(tpyr._TAPS), np.float32),
        np.asarray(jfilters._gauss_kernel1d(7, 2.0), np.float32))


def test_pyramid_level_cuda_raises_on_cpu_tensors(frame):
    img, mask = frame
    with pytest.raises(ValueError):
        tpyr.pyramid_level_cuda(_t(img), _t(mask), *img.shape, True)


# ------------------------------------------------------------ selection

@pytest.fixture(scope="module")
def levels(frame):
    """The port's pyramid of the frame (masked and not) as numpy: both
    packages select from these levels."""
    img, mask = frame
    out = {}
    for masked in (False, True):
        pyr = tpyr.build_pyramid(_t(img), _t(mask) if masked else None,
                                 N_LEVELS, 1.2)
        out[masked] = ([_n(x) for x in pyr.images],
                       [_n(x) for x in pyr.masks])
    return out


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_score(im, m, min_th, border):
    """airdos_tpu/features/orb.py's score before selection: FAST times the
    mask, zeroed outside the detection border."""
    h, w = im.shape
    score = jfast.fast_score_map(im) * m
    yy = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inside = ((yy >= border) & (yy < h - border) &
              (xx >= border) & (xx < w - border))
    return jnp.where(inside, score, 0.0)


def _jax_select(score, quota, cell):
    xs, ys, resp = jax.jit(_select_level_keypoints, static_argnums=(1, 2))(
        jnp.asarray(score), quota, cell, INI_TH, MIN_TH)
    return _n(xs), _n(ys), _n(resp)


QUOTAS = level_quotas(300, N_LEVELS, 1.2)


@pytest.mark.parametrize("quota", ["budget", "over the cells"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("level", range(N_LEVELS))
def test_select_keypoints_matches_jax(levels, level, masked, quota):
    """One level: the port's detection map (tests/test_torch_track_kernels
    holds it to airdos_tpu's) through select_keypoints against airdos_tpu's
    NMS and selection; "over the cells" asks for more slots than the
    level has cells (cell size clipped to 8), so empty cells and zero
    padding are selected too."""
    images, masks = levels[masked]
    im, m = images[level], masks[level]
    h, w = im.shape
    q = QUOTAS[level] if quota == "budget" else 1200
    cell = _cell_size_for(h - 2 * MIN_BORDER, w - 2 * MIN_BORDER, q)
    s = tfast.fast_nms(_t(im), _t(m), MIN_TH, MIN_BORDER)
    before = _launches()
    xs, ys, resp = tsel.select_keypoints([s], [q], [cell], INI_TH)
    assert _launches() == before
    assert xs.dtype == ys.dtype == torch.int64 and xs.shape == (q,)
    want = _jax_select(_jax_score(im, m, MIN_TH, MIN_BORDER), q, cell)
    for a, b in zip((xs, ys, resp), want):
        np.testing.assert_array_equal(_n(a), b)
    assert (_n(resp) > 0).sum() > (3 if level < 3 else 0)


def test_select_keypoints_of_an_image_is_each_level_in_turn(levels):
    """One call for all levels (the kernel's grid): the levels' selections
    back to back, in level order."""
    images, masks = levels[True]
    maps = [tfast.fast_nms(_t(i), _t(m), MIN_TH, MIN_BORDER)
            for i, m in zip(images, masks)]
    cells = [_cell_size_for(s.shape[0] - 2 * MIN_BORDER,
                            s.shape[1] - 2 * MIN_BORDER, q)
             for s, q in zip(maps, QUOTAS)]
    got = tsel.select_keypoints(maps, QUOTAS, cells, INI_TH)
    at = 0
    for s, q, c in zip(maps, QUOTAS, cells):
        one = tsel.select_level_ref(s, q, c, INI_TH)
        for a, b in zip(got, one):
            assert torch.equal(a[at:at + q], b)
        at += q
    assert at == got[0].shape[0] == sum(QUOTAS)


def test_select_keypoints_breaks_ties_as_jax(rng):
    """Sparse maps of four response values: equal maxima inside cells
    (the first in row-major order wins), equal cells inside 4x4 blocks
    (the earlier ranks first) and equal keys across blocks (the lower
    cell index first), boosted and not."""
    h, w = 96, 128
    s = np.zeros((h, w), np.float32)
    ys, xs = np.meshgrid(np.arange(0, h, 2), np.arange(0, w, 2),
                         indexing="ij")
    keep = rng.uniform(size=ys.shape) < 0.3
    s[ys[keep], xs[keep]] = rng.choice([8.0, 10.0, 13.0, 20.0],
                                       int(keep.sum()))
    for q, cell in ((40, 8), (100, 12), (500, 8)):
        got = tsel.select_keypoints([_t(s)], [q], [cell], INI_TH)
        want = _jax_select(s, q, cell)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_n(a), b)


def test_select_kernel_constants_are_the_plain_versions():
    text = (CSRC / "select.cu").read_text()
    assert re.search(r"constexpr float kBoost = (\S+)f;", text).group(1) == \
        str(tsel.INI_BOOST)
    assert re.search(r"constexpr int kBlock = (\d+);", text).group(1) == \
        str(tsel.BLOCK)
    assert re.search(r"constexpr int kMaxLevels = (\d+);", text).group(1) \
        == str(tsel.MAX_LEVELS)
    assert tsel.smem_bytes(836) == 8 * 1024 + 8 * 836


def test_select_keypoints_cuda_raises_on_cpu_tensors():
    s = torch.zeros((64, 96))
    with pytest.raises(ValueError):
        tsel.select_keypoints_cuda([s], [10], [8], INI_TH)


# ------------------------------------- an image's levels in one launch

def _mask_of(mask, kind):
    return None if kind is None else _t(mask.astype(kind))


@pytest.mark.parametrize("mask_kind,erode_k", [(None, 10)] + [
    (kind, k) for kind in ("uint8", "float32") for k in (1, 6, 10, 15, 16)])
def test_build_pyramid_views_match_jax(frame, mask_kind, erode_k):
    """build_pyramid's levels, views into one flat buffer (images from
    level 1 on, masks, blurs; level 0's image the input), against
    airdos_tpu's build_pyramid with the same erosion: images and blurs
    within 1e-4 (this module's pyramid tolerance), masks exact."""
    from airdos_tpu_torch.ops.cuda_build import LEVEL_ALIGN
    img, mask = frame
    jmask = None if mask_kind is None else jnp.asarray(
        mask.astype(np.float32))
    want = jpyr.build_pyramid(jnp.asarray(img), jmask, N_LEVELS, 1.2,
                              mask_erode=erode_k)
    timg = _t(img)
    got = tpyr.build_pyramid(timg, _mask_of(mask, mask_kind), N_LEVELS, 1.2,
                             mask_erode=erode_k)
    assert got.images[0] is timg
    views = got.images[1:] + got.masks + got.blurred
    base = views[0].untyped_storage().data_ptr()
    assert all(v.untyped_storage().data_ptr() == base for v in views)
    assert all(v.storage_offset() % LEVEL_ALIGN == 0 and v.is_contiguous()
               for v in views)
    for lvl in range(N_LEVELS):
        np.testing.assert_allclose(_n(got.images[lvl]),
                                   _n(want.images[lvl]), atol=1e-4)
        np.testing.assert_array_equal(_n(got.masks[lvl]),
                                      _n(want.masks[lvl]))
        np.testing.assert_allclose(
            _n(got.blurred[lvl]),
            _n(jfilters.gaussian_blur7(want.images[lvl])), atol=1e-4)


@pytest.mark.parametrize("mask_kind", [None, "uint8", "float32"])
def test_fast_nms_levels_matches_jax_exactly(frame, mask_kind):
    """An image's detection maps in one call against airdos_tpu's
    fast_score_map -> mask -> interior -> threshold -> nms_strict on each
    of the same levels: exact."""
    img, mask = frame
    pyr = tpyr.build_pyramid(_t(img), _mask_of(mask, mask_kind), N_LEVELS,
                             1.2)
    before = tfast.launches()
    got = tfast.fast_nms_levels(pyr.images, pyr.masks, MIN_TH, MIN_BORDER)
    assert tfast.launches() == before
    assert len(got) == N_LEVELS
    kept = 0
    for im, m, g in zip(pyr.images, pyr.masks, got):
        score = _jax_score(_n(im), _n(m), MIN_TH, MIN_BORDER)
        want = jfast.nms_strict(jnp.where(score > MIN_TH, score, 0.0))
        np.testing.assert_array_equal(_n(g), _n(want))
        kept += int((_n(g) > 0).sum())
    assert kept > 0


def test_level_entries_raise_on_cpu_tensors_and_past_16_levels(frame):
    img, mask = frame
    im, m = _t(img), _t(mask)
    with pytest.raises(ValueError):
        tpyr.build_pyramid_cuda(im, m, N_LEVELS, 1.2)
    with pytest.raises(ValueError, match="17 levels"):
        tpyr.build_pyramid_cuda(im, None, 17, 1.2)
    ones = torch.ones_like(im)
    with pytest.raises(ValueError):
        tfast.fast_nms_levels_cuda([im], [ones], MIN_TH, MIN_BORDER)
    with pytest.raises(ValueError, match="17 levels"):
        tfast.fast_nms_levels_cuda([im] * 17, [ones] * 17, MIN_TH,
                                   MIN_BORDER)


# ------------------------------------------- the front end on a crowd frame

def _crowd_config(cls):
    cfg = cls()
    cfg.camera = small_camera()
    cfg.orb.n_features, cfg.orb.n_levels = 600, N_LEVELS
    cfg.human.ok = True
    cfg.system.is_mask = True
    return cfg


@pytest.fixture(scope="module")
def crowd():
    """A rendered small-camera crowd frame with its segmentation and
    detections, through both packages' FrontEnd: (the torso probes,
    airdos_tpu's (fL, sm, disp), the port's)."""
    world = SyntheticStereoWorld(seed=2, n_points=300, n_humans=4,
                                 crowd=True, cam=small_camera())
    Rwc, twc = world.trajectory(2, 0.1, yaw_rate=0.005)
    d = world.frame(1, Rwc[1], twc[1], 0.1, with_humans=True)
    px = torso_pixels(d.humans_left)
    px[-3:] = [[-5.0, 10.0], [400.0, 30.0], [3.0, 100.0]]
    jfe = JaxFrontEnd(_crowd_config(JaxConfig))
    fLj, _, smj, _, dispj = jfe._build(*jfe.uploads(d), jnp.asarray(px),
                                      with_disparity=True)
    tfe = TorchFrontEnd(_crowd_config(TorchConfig), device="cpu")
    before = _launches()
    fLt, _, smt, _, dispt = tfe._build_impl(*tfe.uploads(d), _t(px), True)
    assert _launches() == before
    return px, (fLj, smj, dispj), (fLt, smt, dispt)


def test_front_end_keypoints_match_jax(crowd):
    _, (fLj, _, _), (fLt, _, _) = crowd
    same = np.all(_n(fLt.xy) == _n(fLj.xy), axis=1) & \
        (_n(fLt.valid) == _n(fLj.valid))
    assert _n(fLj.valid).sum() > 300
    assert same.mean() >= 0.99, same.mean()


def test_front_end_stereo_matches_jax(crowd):
    _, (_, smj, _), (_, smt, _) = crowd
    ref = {k: _n(v) for k, v in smj._asdict().items()}
    got = {k: _n(v) for k, v in smt._asdict().items()}
    assert (ref["best_right"] >= 0).sum() > 100
    assert np.mean(got["best_right"] == ref["best_right"]) >= 0.99
    both = (got["u_right"] >= 0) & (ref["u_right"] >= 0)
    assert both.sum() >= 0.99 * (ref["u_right"] >= 0).sum()
    np.testing.assert_allclose(got["u_right"][both], ref["u_right"][both],
                               atol=1e-3)


def test_front_end_disparity_matches_jax_exactly(crowd):
    px, (_, _, dispj), (_, _, dispt) = crowd
    np.testing.assert_array_equal(_n(dispt), _n(dispj))
    assert (_n(dispt)[-3:] == -1).all()
    assert (_n(dispt) >= 0).sum() >= 5


def test_stereo_sad_kernel_window_is_the_plain_versions():
    text = (CSRC / "stereo_sad.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert (int(consts["kW"]), int(consts["kL"])) == (tsad.SAD_W, tsad.SAD_L)
    assert int(consts["kMaxLevels"]) == tsad.MAX_LEVELS
    # half a warp a keypoint, a level's scale and width a lane
    assert int(consts["kHalf"]) == tsad.LANES == 16 >= tsad.MAX_LEVELS
    assert 32 * int(consts["kWarps"]) // tsad.LANES == tsad.KEYPOINTS
    stride = int(consts["kStride"])
    assert stride % 32 == 16 and stride >= 11 * 11 + 11 * 21


def test_stereo_sad_lanes_load_every_window_column_once():
    """Lane c of a keypoint loads patch column c and strip columns c and
    c + 16: every column of the 11-wide patch and the 21-wide strip once,
    and lane k < 11 then sums SAD k."""
    patch, strip = [], []
    for lane in range(tsad.LANES):
        p, s = tsad.lane_columns(lane)
        patch += [] if p is None else [p]
        strip += s
    assert sorted(patch) == list(range(2 * tsad.SAD_W + 1))
    assert sorted(strip) == list(range(2 * (tsad.SAD_W + tsad.SAD_L) + 1))
    assert 2 * tsad.SAD_L + 1 <= tsad.LANES


@pytest.mark.parametrize("kind", ["8-bit", "bilinear levels"])
def test_stereo_sad_lane_order_is_exact_under_the_pixel_condition(kind):
    """SAD k as lane k sums it (the 121 float32 terms in row-major order
    over two float64 accumulators, then their sum) equals the plain
    version's float64 sum, bit for bit, where every pixel is 0 or at
    least 2^-8: 8-bit windows, and windows of bilinear-level values
    (multiples of 2^-16 from 8-bit images)."""
    rng = np.random.default_rng(len(kind))
    for _ in range(50):
        px = rng.integers(0, 256, (11, 11 + 21)).astype(np.float32)
        if kind == "bilinear levels":
            px = (px * rng.integers(0, 2 ** 16, px.shape)
                  / 2.0 ** 16).astype(np.float32)
            px[(px != 0) & (np.abs(px) < 2.0 ** -8)] = 0.0
        patch = px[:, :11] - px[5, 5]
        strip = px[:, 11:]
        for k in range(11):
            win = strip[:, k:k + 11] - strip[5, 5 + k]
            terms = np.abs(patch - win).astype(np.float32).reshape(-1)
            acc = [0.0, 0.0]
            for j, t in enumerate(terms):
                acc[j & 1] += float(t)
            lanes = np.float32(acc[0] + acc[1])
            want = torch.sum(torch.from_numpy(terms), dtype=torch.float64) \
                .to(torch.float32)
            assert lanes.view(np.int32) == want.numpy().view(np.int32)


@pytest.mark.parametrize("n", [0, 1, 3, 1536])
def test_stereo_sad_outputs_are_views_of_one_allocation(n):
    best, u_r, disp, accept = tsad.outputs(n, "cpu")
    for x, dtype in ((best, torch.float32), (u_r, torch.float32),
                     (disp, torch.float32), (accept, torch.bool)):
        assert x.shape == (n,) and x.dtype == dtype and x.is_contiguous()
    base = best.untyped_storage().data_ptr()
    assert all(x.untyped_storage().data_ptr() == base
               for x in (u_r, disp, accept))
    best.fill_(1.0)
    u_r.fill_(2.0)
    disp.fill_(3.0)
    accept.fill_(True)
    assert (best == 1).all() and (u_r == 2).all() and (disp == 3).all()
    assert accept.all()


def test_stereo_sad_cuda_raises_on_cpu_tensors():
    x = torch.zeros((8, 2))
    i = torch.zeros(8, dtype=torch.int64)
    b = torch.ones(8, dtype=torch.bool)
    im = [torch.zeros((64, 96))]
    with pytest.raises(ValueError):
        tsad.stereo_sad_cuda(x, i, b, x, i, b, im, im,
                             torch.tensor([96]), torch.ones(1), 100.0)


def test_patch_disparity_matches_jax_at_the_image_edges(rng):
    """Probes whose windows the clamps cut at every edge, partly covered
    strips near the left edge, probes off the image and padded (-1, -1)
    slots, on an 8-bit image pair 5 px apart: exact."""
    imL = rng.integers(0, 256, (90, 130)).astype(np.float32)
    imR = np.roll(imL, -5, axis=1)
    px = np.array([[0.0, 0.0], [129.0, 89.0], [3.0, 45.0], [40.0, 2.0],
                   [60.4, 88.6], [126.5, 44.5], [52.0, 60.0], [51.0, 61.0],
                   [-3.0, 20.0], [20.0, 95.0], [-1.0, -1.0]], np.float32)
    before = _launches()
    got = _n(tdisp.patch_disparity(_t(imL), _t(imR), _t(px)))
    assert _launches() == before
    want = _n(jax_patch_disparity(jnp.asarray(imL), jnp.asarray(imR),
                                  jnp.asarray(px)))
    np.testing.assert_array_equal(got, want)
    assert (got[-3:] == -1).all() and (got >= 0).sum() >= 3


def test_patch_disparity_kernel_limits_are_the_wrappers():
    text = (CSRC / "disparity.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert (int(consts["kMaxDisp"]), int(consts["kMaxBlock"])) == \
        (tdisp.MAX_DISP, tdisp.MAX_BLOCK)


def test_patch_disparity_cuda_raises_on_cpu_tensors():
    im = torch.zeros((64, 96))
    with pytest.raises(ValueError):
        tdisp.patch_disparity_cuda(im, im, torch.zeros((4, 2)))
