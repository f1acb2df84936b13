"""The port's static stereo tracking slice against airdos_tpu (CPU).

Both packages get the same numpy frames.  Stated tolerances:
- rendered frames: the port's numpy rasterizers give the same static
  frames exactly; frames with humans (thick-line limbs) differ on < 0.5%
  of pixels;
- the fused step on one recorded input tuple: R within 1e-4 (Frobenius),
  t within 1e-4 m, match assignments >= 99% equal;
- the 14-frame tracking-only run (``Tracking(..., local_mapper=None)`` in
  both packages): the same OK state and branch per frame, the same
  keyframe count, ATE within 10% or 2 mm of airdos_tpu's.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import airdos_tpu.config as jcfg
import airdos_tpu_torch.config as tcfg
from airdos_tpu.io.synthetic import SyntheticStereoWorld as JaxWorld
from airdos_tpu.io.synthetic import small_camera
from airdos_tpu.io.tum import ate_rmse
from airdos_tpu.slam.frame import FrontEnd as JaxFrontEnd
from airdos_tpu.slam.map import SlamMap as JaxMap
from airdos_tpu.slam.tracking import Tracking as JaxTracking
from airdos_tpu_torch.convert import (config_from, desc_to_numpy,
                                      desc_to_tensor, step_tables_to_device)
from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld as TorchWorld
from airdos_tpu_torch.slam.fused import make_full_track_step
from airdos_tpu_torch.slam.system import System
from airdos_tpu_torch.slam.frame import FrontEnd as TorchFrontEnd
from airdos_tpu_torch.slam.map import SlamMap as TorchMap
from airdos_tpu_torch.slam.tracking import Tracking

N_FRAMES = 14


def small_config():
    """tests/test_system_e2e.py's small_config, tracking-only."""
    cfg = jcfg.SlamConfig()
    cfg.camera = small_camera()
    cfg.orb.n_features = 600
    cfg.orb.n_levels = 4
    cfg.human.ok = False
    cfg.device.max_keypoints = 1024
    cfg.device.max_local_kfs = 8
    cfg.device.max_fixed_kfs = 4
    cfg.device.max_local_points = 1024
    cfg.device.max_ba_edges = 4096
    cfg.device.max_trajectories = 2
    cfg.device.max_trajectory_len = 16
    return cfg


@pytest.fixture(scope="module")
def frames():
    world = TorchWorld(seed=0, n_points=200, cam=config_from(small_config()).camera)
    return [(d, Rwc, twc) for d, Rwc, twc in
            world.sequence(N_FRAMES, dt=0.1, yaw_rate=0.008)]


@pytest.fixture(scope="module")
def jax_run(frames):
    cfg = small_config()
    trk = JaxTracking(cfg, JaxFrontEnd(cfg), JaxMap(), local_mapper=None)
    per = []
    for data, _, _ in frames:
        trk.track(data)
        per.append((trk.state.name, trk.last_branch))
    _, _, t_est = trk.trajectory_tum()
    gt = np.asarray([twc for _, _, twc in frames])
    return dict(trk=trk, per=per, n_kfs=trk.map.n_keyframes(),
                ate=ate_rmse(t_est, gt[:len(t_est)]))


@pytest.fixture(scope="module")
def torch_run(frames):
    cfg = config_from(small_config())
    trk = Tracking(cfg, TorchFrontEnd(cfg), TorchMap(), local_mapper=None)
    per = []
    for data, _, _ in frames:
        trk.track(data)
        per.append((trk.state.name, trk.last_branch))
    _, _, t_est = trk.trajectory_tum()
    gt = np.asarray([twc for _, _, twc in frames])
    return dict(trk=trk, per=per, n_kfs=trk.map.n_keyframes(),
                ate=ate_rmse(t_est, gt[:len(t_est)]))


def test_static_frames_render_identically(frames):
    world = JaxWorld(seed=0, n_points=200, cam=small_camera())
    for (d_t, _, _), (d_j, _, _) in zip(
            frames[:3], world.sequence(3, dt=0.1, yaw_rate=0.008)):
        np.testing.assert_array_equal(d_t.image_left, d_j.image_left)
        np.testing.assert_array_equal(d_t.image_right, d_j.image_right)


def test_human_frames_render_nearly_identically():
    kw = dict(seed=3, n_points=100, cam=small_camera(), n_humans=3)
    jw, tw = JaxWorld(**kw), TorchWorld(**kw)
    Rwc, twc = jw.trajectory(1, 0.1)
    d_j = jw.frame(0, Rwc[0], twc[0], 0.0, with_depth=True)
    d_t = tw.frame(0, Rwc[0], twc[0], 0.0, with_depth=True)
    assert d_j.seg_left is not None and d_j.seg_left.any()
    for name in ("image_left", "image_right", "depth", "seg_left", "seg_right"):
        a, b = getattr(d_j, name), getattr(d_t, name)
        assert a.shape == b.shape
        share = np.mean(a != b)
        assert share < 0.005, (name, share)
    np.testing.assert_array_equal(d_j.humans_left, d_t.humans_left)


def test_tracking_only_run_matches_jax(jax_run, torch_run):
    assert jax_run["per"][:2] == [("OK", "init"), ("OK", "ref")]
    assert torch_run["per"] == jax_run["per"]
    assert torch_run["n_kfs"] == jax_run["n_kfs"]
    tol = max(0.1 * jax_run["ate"], 0.002)
    assert abs(torch_run["ate"] - jax_run["ate"]) <= tol, \
        (torch_run["ate"], jax_run["ate"])


def test_fused_step_matches_jax_on_recorded_inputs(jax_run):
    trk = jax_run["trk"]
    step_args, want_disp = trk._last_step_args
    ref = jax.device_get(trk._full_step(*step_args, with_disparity=want_disp))
    (imL, imR, _, _, _, prior, last_f32, desc_p, cand_f32, desc_c,
     forward, backward) = jax.device_get(step_args)

    cfg = config_from(small_config())
    step = make_full_track_step(TorchFrontEnd(cfg), cfg)
    out = step(torch.from_numpy(np.array(imL)),
               torch.from_numpy(np.array(imR)),
               torch.from_numpy(np.array(prior)),
               *step_tables_to_device(last_f32, desc_p, cand_f32, desc_c, "cpu"),
               bool(forward), bool(backward))

    R_ref, t_ref = ref.scalars[:9].reshape(3, 3), ref.scalars[9:12]
    R_out, t_out = out.scalars[:9].reshape(3, 3), out.scalars[9:12]
    assert np.linalg.norm(R_out - R_ref) < 1e-4
    assert np.abs(t_out - t_ref).max() < 1e-4
    assert ref.scalars[12] >= 20          # the motion stage matched
    np.testing.assert_allclose(out.scalars[12:14], ref.scalars[12:14],
                               rtol=0.01)
    # features: slots, validity, octaves; then the match assignments
    np.testing.assert_array_equal(out.feat_i32[:, :2], ref.feat_i32[:, :2])
    np.testing.assert_allclose(out.feat_f32[:, :4], ref.feat_f32[:, :4],
                               atol=1e-3)
    assert np.mean(out.desc32 == ref.desc32) >= 0.99
    for col in (2, 3):
        assert np.mean(out.feat_i32[:, col] == ref.feat_i32[:, col]) >= 0.99


def _fields(mod, cls_name):
    cls = getattr(mod, cls_name)
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else type(f.default_factory()).__name__)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("cls_name", [
    "CameraConfig", "OrbConfig", "HumanConfig", "OptimizerConfig",
    "SystemFlags", "SchedulerConfig", "DeviceConfig", "SlamConfig"])
def test_config_fields_and_defaults_match_jax(cls_name):
    assert _fields(tcfg, cls_name) == _fields(jcfg, cls_name)


def test_config_from_jax_round_trips():
    cfg = small_config()
    cfg.optimizer.velocity_damping = 0.5
    port = config_from(cfg)
    assert isinstance(port, tcfg.SlamConfig)
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert port.th_depth_m == cfg.th_depth_m


def test_descriptor_conversion_round_trips(rng):
    d = rng.integers(0, 2 ** 32, (37, 8), dtype=np.uint64).astype(np.uint32)
    t = desc_to_tensor(d, "cpu")
    assert t.dtype == torch.int32 and t.shape == (37, 8)
    np.testing.assert_array_equal(desc_to_numpy(t), d)


def test_port_import_leaves_jax_out():
    code = ("import sys, airdos_tpu_torch.slam.system, airdos_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'airdos_tpu' or m.startswith('airdos_tpu.') or m == 'cv2']; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("section,field,value", [
    ("human", "ok", True),
    ("system", "is_mask", True),
    ("system", "is_offline", False),
    (None, "vocabulary_path", "voc.npz"),
    (None, "enable_loop_closing", True),
])
def test_out_of_slice_configs_raise(section, field, value):
    cfg = config_from(small_config())
    setattr(getattr(cfg, section) if section else cfg, field, value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        System(cfg)
