"""The port's stereo and projection matchers against airdos_tpu (CPU).

Both packages get the same numpy inputs: ORB features of two consecutive
rendered stereo frames, as airdos_tpu's extractor computes them.  Stated
tolerances:
- stereo: best_right >= 99% equal; u_right within 1e-3 px where both accept;
- projection matches (feat_idx, point_of_feat) >= 99% equal, match counts
  within 1%;
- _resolve_unique and the rotation-histogram filter: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airdos_tpu.matching.projection as jproj
import airdos_tpu.matching.stereo as jstereo
import airdos_tpu_torch.matching.projection as tproj
import airdos_tpu_torch.matching.stereo as tstereo
from airdos_tpu.features.orb import OrbExtractor
from airdos_tpu.io.synthetic import SyntheticStereoWorld, small_camera
from airdos_tpu.ops.pyramid import build_pyramid, level_shapes

N_LEVELS = 4
SCALES = np.asarray([1.2 ** l for l in range(N_LEVELS)], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


_pyramid = jax.jit(lambda im: build_pyramid(im, None, N_LEVELS, 1.2))


def _stereo_inputs(ext, data, cam):
    imL = jnp.asarray(data.image_left.astype(np.uint8).astype(np.float32))
    imR = jnp.asarray(data.image_right.astype(np.uint8).astype(np.float32))
    pyrL, pyrR = _pyramid(imL), _pyramid(imR)
    extract = jax.jit(ext._extract_from_pyramid)
    fL, fR = extract(pyrL), extract(pyrR)
    widths = np.asarray([s[1] for s in level_shapes(cam.height, cam.width,
                                                    N_LEVELS, 1.2)])
    return dict(
        xy_l=np.asarray(fL.xy), oct_l=np.asarray(fL.octave),
        desc_l=np.asarray(fL.desc32), valid_l=np.asarray(fL.valid),
        ang_l=np.asarray(fL.angle),
        xy_r=np.asarray(fR.xy), oct_r=np.asarray(fR.octave),
        desc_r=np.asarray(fR.desc32), valid_r=np.asarray(fR.valid),
        pyr_l=np.asarray(jstereo.stack_pyramid(pyrL.images)),
        pyr_r=np.asarray(jstereo.stack_pyramid(pyrR.images)),
        widths=widths)


def _run_stereo(inp, cam, backend):
    if backend == "jax":
        m = jax.jit(jstereo.stereo_match)(
            *(jnp.asarray(inp[k]) for k in ("xy_l", "oct_l", "desc_l", "valid_l",
                                            "xy_r", "oct_r", "desc_r", "valid_r",
                                            "pyr_l", "pyr_r")),
            jnp.asarray(inp["widths"], jnp.int32), jnp.asarray(SCALES),
            jnp.float32(cam.bf), jnp.float32(cam.baseline))
        return {k: np.asarray(v) for k, v in m._asdict().items()}
    desc = {k: _t(inp[k].view(np.int32)) for k in ("desc_l", "desc_r")}
    m = tstereo.stereo_match(
        _t(inp["xy_l"]), _t(inp["oct_l"]).long(), desc["desc_l"],
        _t(inp["valid_l"]), _t(inp["xy_r"]), _t(inp["oct_r"]).long(),
        desc["desc_r"], _t(inp["valid_r"]), _t(inp["pyr_l"]), _t(inp["pyr_r"]),
        _t(inp["widths"]).long(), _t(SCALES), cam.bf, cam.baseline)
    return {k: v.numpy() for k, v in m._asdict().items()}


@pytest.fixture(scope="module")
def scene():
    cam = small_camera()
    world = SyntheticStereoWorld(seed=0, n_points=200, cam=cam)
    frames = [f for f in world.sequence(2, dt=0.1, yaw_rate=0.008)]
    ext = OrbExtractor(600, 1.2, N_LEVELS)
    out = []
    for data, Rwc, twc in frames:
        inp = _stereo_inputs(ext, data, cam)
        inp["stereo_jax"] = _run_stereo(inp, cam, "jax")
        inp["Rcw"] = Rwc.T.astype(np.float32)
        inp["tcw"] = (-Rwc.T @ twc).astype(np.float32)
        inp["ow"] = twc.astype(np.float32)
        out.append(inp)
    return cam, out


def test_stereo_match_matches_jax(scene):
    cam, frames = scene
    for inp in frames:
        ref = inp["stereo_jax"]
        got = _run_stereo(inp, cam, "torch")
        assert (ref["best_right"] >= 0).sum() > 100
        assert np.mean(got["best_right"] == ref["best_right"]) >= 0.99
        both = (got["u_right"] >= 0) & (ref["u_right"] >= 0)
        assert both.sum() >= 0.99 * (ref["u_right"] >= 0).sum()
        np.testing.assert_allclose(got["u_right"][both], ref["u_right"][both],
                                   atol=1e-3)


def _last_frame_points(inp, cam):
    """World points of the features with stereo depth, from the frame's
    ground-truth pose (the tracker's last-frame table)."""
    depth = inp["stereo_jax"]["depth"]
    valid = depth > 0
    z = np.where(valid, depth, 1.0)
    x = (inp["xy_l"][:, 0] - cam.cx) * z / cam.fx
    y = (inp["xy_l"][:, 1] - cam.cy) * z / cam.fy
    xc = np.stack([x, y, z], axis=1)
    xw = (inp["Rcw"].T @ (xc - inp["tcw"]).T).T.astype(np.float32)
    return xw, valid


def test_match_last_frame_matches_jax(scene):
    cam, (a, b) = scene
    xw, valid = _last_frame_points(a, cam)
    u_right = b["stereo_jax"]["u_right"]
    taken = np.zeros(len(b["xy_l"]), bool)
    common = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.width, cam.height)
    ref = jproj.match_last_frame(
        jnp.asarray(xw), jnp.asarray(a["desc_l"]), jnp.asarray(a["oct_l"]),
        jnp.asarray(a["ang_l"]), jnp.asarray(valid),
        jnp.asarray(b["Rcw"]), jnp.asarray(b["tcw"]), jnp.asarray(b["xy_l"]),
        jnp.asarray(u_right), jnp.asarray(b["oct_l"]), jnp.asarray(b["ang_l"]),
        jnp.asarray(b["desc_l"]), jnp.asarray(b["valid_l"]),
        jnp.asarray(taken), *common, jnp.asarray(SCALES), 7.0, False, False)
    got = tproj.match_last_frame(
        _t(xw), _t(a["desc_l"].view(np.int32)), _t(a["oct_l"]).long(),
        _t(a["ang_l"]), _t(valid), _t(b["Rcw"]), _t(b["tcw"]), _t(b["xy_l"]),
        _t(u_right), _t(b["oct_l"]).long(), _t(b["ang_l"]),
        _t(b["desc_l"].view(np.int32)), _t(b["valid_l"]), _t(taken),
        *common, _t(SCALES), 7.0, False, False)
    n_ref = int(ref.n_matches)
    assert n_ref > 50
    assert abs(int(got.n_matches) - n_ref) <= 0.01 * n_ref
    assert np.mean(got.feat_idx.numpy() == np.asarray(ref.feat_idx)) >= 0.99
    assert np.mean(got.point_of_feat.numpy() ==
                   np.asarray(ref.point_of_feat)) >= 0.99


def test_match_local_points_matches_jax(scene):
    cam, (a, b) = scene
    xw, valid = _last_frame_points(a, cam)
    d = xw - a["ow"][None, :]
    dist = np.linalg.norm(d, axis=1)
    normal = (d / np.maximum(dist[:, None], 1e-9)).astype(np.float32)
    maxd = (1.2 * dist * 1.2 ** a["oct_l"]).astype(np.float32)
    mind = (0.8 * dist * 1.2 ** a["oct_l"] / 1.2 ** (N_LEVELS - 1)).astype(np.float32)
    u_right = b["stereo_jax"]["u_right"]
    taken = np.zeros(len(b["xy_l"]), bool)
    taken[::7] = True
    common = (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.width, cam.height)
    log_scale = float(np.log(1.2))
    ref = jproj.match_local_points(
        jnp.asarray(xw), jnp.asarray(a["desc_l"]), jnp.asarray(valid),
        jnp.asarray(normal), jnp.asarray(maxd), jnp.asarray(mind),
        jnp.asarray(b["Rcw"]), jnp.asarray(b["tcw"]), jnp.asarray(b["ow"]),
        jnp.asarray(b["xy_l"]), jnp.asarray(u_right), jnp.asarray(b["oct_l"]),
        jnp.asarray(b["desc_l"]), jnp.asarray(b["valid_l"]), jnp.asarray(taken),
        *common, jnp.asarray(SCALES), log_scale, N_LEVELS, 1.0)
    got = tproj.match_local_points(
        _t(xw), _t(a["desc_l"].view(np.int32)), _t(valid), _t(normal),
        _t(maxd), _t(mind), _t(b["Rcw"]), _t(b["tcw"]), _t(b["ow"]),
        _t(b["xy_l"]), _t(u_right), _t(b["oct_l"]).long(),
        _t(b["desc_l"].view(np.int32)), _t(b["valid_l"]), _t(taken),
        *common, _t(SCALES), log_scale, N_LEVELS, 1.0)
    n_ref = int(ref.n_matches)
    assert n_ref > 50
    assert abs(int(got.n_matches) - n_ref) <= 0.01 * n_ref
    assert np.mean(got.feat_idx.numpy() == np.asarray(ref.feat_idx)) >= 0.99
    assert np.mean(got.point_of_feat.numpy() ==
                   np.asarray(ref.point_of_feat)) >= 0.99


@pytest.mark.parametrize("n_points,n_feats", [(300, 64), (50, 500)])
def test_resolve_unique_exact(rng, n_points, n_feats):
    best_feat = rng.integers(0, n_feats, n_points)
    best_dist = rng.integers(0, 40, n_points)      # many ties
    has = rng.uniform(size=n_points) < 0.8
    rj = jproj._resolve_unique(jnp.asarray(best_feat, jnp.int32),
                               jnp.asarray(best_dist, jnp.int32),
                               jnp.asarray(has), n_feats)
    rt = tproj._resolve_unique(_t(best_feat), _t(best_dist.astype(np.int32)),
                               _t(has), n_feats)
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_rotation_consistency_exact(rng):
    n = 400
    ang_ref = rng.uniform(0, 360, n).astype(np.float32)
    # a dominant rotation of ~20 deg plus uniform clutter
    ang_cur = np.where(rng.uniform(size=n) < 0.7,
                       ang_ref - 20 + rng.normal(0, 3, n),
                       rng.uniform(0, 360, n)).astype(np.float32) % 360
    has = rng.uniform(size=n) < 0.9
    kj = jproj._rotation_consistency(jnp.asarray(ang_ref), jnp.asarray(ang_cur),
                                     jnp.asarray(has))
    kt = tproj._rotation_consistency(_t(ang_ref), _t(ang_cur), _t(has))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert 0 < kt.sum() < has.sum()
