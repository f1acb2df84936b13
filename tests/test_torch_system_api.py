"""The rest of System's API in the port against airdos_tpu (CPU), and the
properties of airdos_tpu's suite that ROADMAP section 3 listed as held by
no port test.

Both packages track tests/test_system_e2e.py's 14 small-camera frames
offline: frames 0-7 mapped, 8-13 in localization-only mode, then
``reset`` and frames 6-13 again.  Stated tolerances:

- per frame the same state and branch; no keyframe and no point added
  while localizing, in both; after the reset an empty map and
  NOT_INITIALIZED in both, then the same keyframe ids;
- every frame's pose within 5 mm (t) / 1e-3 (R) of airdos_tpu's: the two
  packages' local BAs sum in other orders, ~1e-5 m a keyframe, and the
  temporary VO points of localization-only mode carry that into the
  frames that match against them.

Port only, with airdos_tpu's own bounds: tests/test_system_e2e.py's
``reference_exact()`` run, tests/test_loop_precision.py's loop-free
corridor (zero loops closed), tests/test_global_ba.py's 200-keyframe
problem and schedule (the mean camera-centre error below a quarter of the
start), ``prefetch`` (bit-equal frames, the newest kept), the
AIRDOS_EVENT_LOG / AIRDOS_TRACE_DIR hooks, and that importing the port
imports neither jax nor airdos_tpu.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airdos_tpu.config import SlamConfig
from airdos_tpu.geometry.se3 import se3_exp
from airdos_tpu.slam.system import System as JaxSystem
from airdos_tpu_torch.convert import config_from
from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld, small_camera
from airdos_tpu_torch.io.tum import ate_rmse
from airdos_tpu_torch.slam.frame import FrontEnd
from airdos_tpu_torch.slam.system import System
from airdos_tpu_torch.solvers.global_ba import global_bundle_adjust
from airdos_tpu_torch.utils.obs import Profiler

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


def small_config():
    """tests/test_system_e2e.py's small_config (human layer off)."""
    cfg = SlamConfig()
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
def vo_frames():
    world = SyntheticStereoWorld(seed=0, n_points=200, cam=small_camera())
    return [(d, twc) for d, _, twc in
            world.sequence(14, dt=0.1, yaw_rate=0.008)]


def _api_run(slam, frames):
    """Frames 0-7 mapped, 8-13 localized, then reset and 6-13 mapped."""
    per = []

    def step(i):
        f = slam.track_stereo(frames[i][0])
        per.append(dict(state=slam.tracking.state.name,
                        branch=slam.tracking.last_branch,
                        Rcw=f.Rcw.copy(), tcw=f.tcw.copy(),
                        kfs=sorted(slam.map.kfs),
                        n_points=slam.map.n_points()))

    for i in range(8):
        step(i)
    slam.activate_localization_mode()
    for i in range(8, 14):
        step(i)
    slam.deactivate_localization_mode()
    slam.reset()
    after = (slam.map.n_keyframes(), slam.tracking.state.name,
             len(slam.tracking.records))
    for i in range(6, 14):
        step(i)
    slam.shutdown()
    return per, after


@pytest.fixture(scope="module")
def jax_api(vo_frames):
    return _api_run(JaxSystem(small_config()), vo_frames)


@pytest.fixture(scope="module")
def port_api(vo_frames):
    return _api_run(System(config_from(small_config()), device="cpu"),
                    vo_frames)


def _assert_same_frames(jp, tp):
    assert [(p["state"], p["branch"]) for p in tp] == \
        [(p["state"], p["branch"]) for p in jp]
    assert [p["kfs"] for p in tp] == [p["kfs"] for p in jp]
    for a, b in zip(tp, jp):
        assert np.abs(a["tcw"] - b["tcw"]).max() < 5e-3
        assert np.abs(a["Rcw"] - b["Rcw"]).max() < 1e-3


def test_localization_only_mode_matches_airdos_tpu(jax_api, port_api):
    jp, tp = jax_api[0][:14], port_api[0][:14]
    _assert_same_frames(jp, tp)
    for per in (jp, tp):
        assert all(p["state"] == "OK" for p in per)
        # the map is frozen from frame 8 on: no keyframe, no point
        assert all(p["kfs"] == per[7]["kfs"] for p in per[8:])
        assert all(p["n_points"] == per[7]["n_points"] for p in per[8:])


def test_reset_then_reinitialization_matches_airdos_tpu(jax_api, port_api):
    assert port_api[1] == jax_api[1] == (0, "NOT_INITIALIZED", 0)
    jp, tp = jax_api[0][14:], port_api[0][14:]
    _assert_same_frames(jp, tp)
    assert tp[0]["branch"] == "init" and tp[-1]["state"] == "OK"
    assert len(tp[-1]["kfs"]) >= 2


def test_reference_exact_preset_tracks(vo_frames):
    """tests/test_system_e2e.py:112-130: the drop-in-exact preset (raw
    constant-velocity extrapolation, the thRefRatio keyframe schedule)
    tracks the sequence end to end."""
    cfg = config_from(small_config()).reference_exact()
    assert cfg.optimizer.velocity_damping == 1.0
    assert cfg.optimizer.kf_ref_schedule == "reference"
    slam = System(cfg, device="cpu")
    for data, _ in vo_frames:
        slam.track_stereo(data)
    assert slam.tracking.state.name == "OK"
    assert slam.map.n_keyframes() >= 2
    _, _, twc_e = slam.tracking.trajectory_tum()
    gt = np.asarray([t for _, t in vo_frames])
    assert ate_rmse(twc_e, gt[:len(twc_e)]) < 2.0
    slam.shutdown()


def test_loop_free_corridor_closes_no_loop():
    """tests/test_loop_precision.py: a forward corridor that revisits
    nothing closes no loop (DetectLoop's covisibility exclusion and
    3-consistency, the >= 40-point ComputeSim3 gate)."""
    cfg = config_from(small_config())
    cfg.camera.fps = 5.0
    cfg.enable_loop_closing = True
    world = SyntheticStereoWorld(seed=0, n_points=300, cam=cfg.camera)
    slam = System(cfg, device="cpu")
    for data, _, _ in world.sequence(14, dt=0.1):
        slam.track_stereo(data)
    assert slam.tracking.state.name == "OK"
    assert slam.loop_closer is not None
    assert slam.loop_closer.n_loops_closed == 0
    slam.shutdown()


def test_global_ba_200_keyframe_corridor_bound():
    """tests/test_global_ba.py:39-106's problem and schedule (5 Huber + 10
    plain steps, 64 CG iterations) through the port's solver: every free
    keyframe moves and the mean camera-centre error falls below a quarter
    of the start."""
    rng = np.random.default_rng(0)
    fx = fy = 300.0
    cx, cy = 160.0, 120.0
    bf = 60.0
    C, P = 200, 3000
    cam_t_gt = np.stack([np.array([0.01 * c, 0.0, 0.25 * c])
                         for c in range(C)]).astype(np.float32)
    cam_R_gt = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    pts_gt = np.stack([
        rng.uniform(-6, 6, P), rng.uniform(-4, 4, P),
        rng.uniform(2, 0.25 * C + 10, P)], axis=1).astype(np.float32)
    e_cam, e_pt, e_obs = [], [], []
    for c in range(C):
        xc = pts_gt - cam_t_gt[c]
        z = xc[:, 2]
        u = fx * xc[:, 0] / np.where(z > 0.1, z, 1) + cx
        v = fy * xc[:, 1] / np.where(z > 0.1, z, 1) + cy
        ok = (z > 1.0) & (z < 25.0) & (u > 0) & (u < 320) & (v > 0) & \
            (v < 240)
        sel = np.nonzero(ok)[0]
        sel = sel[rng.permutation(len(sel))[:60]]
        for p in sel:
            e_cam.append(c)
            e_pt.append(p)
            e_obs.append([u[p] + rng.normal(0, 0.2),
                          v[p] + rng.normal(0, 0.2),
                          u[p] - bf / z[p] + rng.normal(0, 0.2)])
    E = len(e_cam)
    assert E > C * 40
    cam_t_n = cam_t_gt + np.linspace(0, 1, C)[:, None] * \
        np.array([0.2, 0.1, 0.15], np.float32)
    cam_R_n = cam_R_gt.copy()
    for c in range(1, C):       # the JAX test's drift, through its se3_exp
        w = np.asarray([0.0, 0.0005 * c, 0.0], np.float32)
        dR, _ = se3_exp(jnp.asarray(np.concatenate(
            [np.zeros(3, np.float32), w])))
        cam_R_n[c] = np.asarray(dR) @ cam_R_gt[c]
    pts_n = pts_gt + rng.normal(0, 0.05, pts_gt.shape).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    tcw_n = -np.einsum("cij,cj->ci", cam_R_n, cam_t_n).astype(np.float32)

    t = torch.from_numpy
    res = global_bundle_adjust(
        t(cam_R_n), t(tcw_n), t(fixed), t(pts_n),
        torch.ones(P, dtype=torch.bool),
        t(np.asarray(e_cam, np.int32)), t(np.asarray(e_pt, np.int32)),
        t(np.asarray(e_obs, np.float32)), torch.ones(E),
        torch.ones(E, dtype=torch.bool), fx, fy, cx, cy, bf,
        iters1=5, iters2=10, cg_iters=64)
    R_out, t_out = res.R.numpy(), res.t.numpy()
    moved = np.linalg.norm(t_out[1:] - tcw_n[1:], axis=1)
    assert (moved > 1e-5).mean() > 0.99
    ctr_out = -np.einsum("cij,ci->cj", R_out, t_out)
    err_before = np.linalg.norm(cam_t_n - cam_t_gt, axis=1).mean()
    err_after = np.linalg.norm(ctr_out - cam_t_gt, axis=1).mean()
    assert err_after < 0.25 * err_before, (err_before, err_after)


def test_prefetch_gives_the_same_frame_and_keeps_the_newest(vo_frames):
    fe = FrontEnd(config_from(small_config()), device="cpu")
    d3, d4 = vo_frames[3][0], vo_frames[4][0]
    plain = fe.build_frame(d3)
    fe.prefetch(d3)
    fe.prefetch(d4)                     # replaces the prefetch of frame 3
    assert list(fe._prefetched) == [d4.index]
    again = fe.build_frame(d3)          # uploaded now, frame 4 still kept
    assert list(fe._prefetched) == [d4.index]
    fe.prefetch(d3)
    pre = fe.build_frame(d3)            # the prefetched uploads, taken
    assert fe._prefetched == {}
    for f in (again, pre):
        for k in ("xy", "desc32", "octave", "valid", "u_right", "depth"):
            np.testing.assert_array_equal(getattr(f, k), getattr(plain, k))


def test_event_log_and_trace_dir_hooks(vo_frames, tmp_path, monkeypatch):
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("AIRDOS_EVENT_LOG", str(log))
    monkeypatch.setenv("AIRDOS_TRACE_DIR", str(tmp_path / "trace"))
    slam = System(config_from(small_config()), device="cpu")
    slam.profiler.start_device_trace()
    for data, _ in vo_frames[:2]:
        slam.track_stereo(data)
    path = slam.profiler.stop_device_trace()
    slam.shutdown()
    slam.events.close()
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["index"] for r in recs if r["event"] == "frame"] == [0, 1]
    assert path.parent == tmp_path / "trace" and path.stat().st_size > 0
    assert Profiler().stop_device_trace() is None


def test_importing_the_port_imports_neither_jax_nor_airdos_tpu():
    code = (
        "import pkgutil, sys, importlib, airdos_tpu_torch\n"
        "for m in pkgutil.walk_packages(airdos_tpu_torch.__path__,\n"
        "                               'airdos_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'airdos_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules\n"
        "           if n.startswith('airdos_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 40
