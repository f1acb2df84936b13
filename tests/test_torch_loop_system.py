"""The slice as a whole: tests/test_loop_closure.py's pillar orbit (84
frames, small camera, Camera.fps 5, enable_loop_closing) through
airdos_tpu and the port (CPU), on the same rendered frames.  Stated
tolerances:

- the port's synthetic world is pixel-equal to airdos_tpu's (two frames);
- the port: every frame OK, >= 1 loop closed, a loop edge, ATE < 0.15 m
  (tests/test_loop_closure.py's bounds), the same (keyframe, candidate)
  pair closed first as airdos_tpu, ATE within 0.01 m of airdos_tpu's
  (the two runs' maps differ by float32 rounding from the first local BA
  on, ~1e-5 m per keyframe, which the loop correction and the global BA
  carry through: both ATEs are a few millimetres);
- compute_sim3 -> correct on the map airdos_tpu held when its closer
  called compute_sim3 for the loop it closed, carried across with the
  closer's state: the same loop points and matches (both >= 99% of
  either side), S12 within 1e-3 (R) / 1e-3 m (t), and after the
  correction, its essential graph and global BA, every keyframe within
  2e-3 (R) / 5e-3 m (t) of airdos_tpu's: both packages solve the same
  problems in float32 with sums in other orders, and the 20-step global BA
  moves far points along their rays (the map's points are compared at
  their median, within 5e-3 m).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

from airdos_tpu.config import SlamConfig
from airdos_tpu.io.synthetic import SyntheticStereoWorld as JaxWorld
from airdos_tpu.io.tum import ate_rmse
from airdos_tpu.slam.loop_closing import LoopCloser as JaxLoopCloser
from airdos_tpu.slam.system import System as JaxSystem
from airdos_tpu_torch.convert import (config_from, loop_closer_state_from,
                                      map_from, vocabulary_from)
from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
from airdos_tpu_torch.io.synthetic import small_camera as t_small_camera
from airdos_tpu_torch.slam.ba_driver import Fuser, GlobalBA
from airdos_tpu_torch.slam.keyframe_db import KeyFrameDatabase
from airdos_tpu_torch.slam.loop_closing import LoopCloser
from airdos_tpu_torch.slam.system import System

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)

N = 84
WORLD = dict(seed=1, n_points=300, centered=True,
             world_size=(16.0, 3.0, 16.0), clear_ring=(1.35, 0.0, 1.35, 0.7),
             ring_outside_only=True, room_radius=4.5,
             pillar=(1.35, 0.0, 0.55, 8))


def _cfg():
    from airdos_tpu.io.synthetic import small_camera
    cfg = SlamConfig()
    cfg.camera = small_camera()
    cfg.camera.fps = 5.0
    cfg.orb.n_features = 600
    cfg.orb.n_levels = 4
    cfg.device.max_keypoints = 1024
    cfg.device.max_local_kfs = 8
    cfg.device.max_fixed_kfs = 4
    cfg.device.max_local_points = 1024
    cfg.device.max_ba_edges = 4096
    cfg.enable_loop_closing = True
    return cfg


@pytest.fixture(scope="module")
def orbit():
    world = SyntheticStereoWorld(cam=t_small_camera(), **WORLD)
    Rwc, twc = world.orbit_loop_trajectory(N, radius=1.35, laps=1.22)
    frames = [world.frame(i, Rwc[i], twc[i], i * 0.2, with_humans=False)
              for i in range(N)]
    return world, Rwc, twc, frames


@pytest.fixture(scope="module")
def jax_run(orbit):
    """airdos_tpu over the frames; its loop closer's state and map are
    snapshot at the compute_sim3 call that led to its first closure, and
    its map after that closure."""
    _, _, twc, frames = orbit
    calls, closed = [], []
    real_sim3, real_correct = JaxLoopCloser.compute_sim3, \
        JaxLoopCloser.correct

    def compute_sim3(self, kf, cand_id):
        snap = dict(map=map_from(self.map), kf=kf.id, cand=cand_id,
                    voc=self.db.voc, closer=_closer_state(self))
        res = real_sim3(self, kf, cand_id)
        if res is not None and not closed:
            snap["res"] = res
            calls.append(snap)
        return res

    def correct(self, kf, res):
        ok = real_correct(self, kf, res)
        if ok:
            closed.append((kf.id, res[4]))
            if len(closed) == 1:
                calls[-1]["after"] = map_from(self.map)
        return ok

    JaxLoopCloser.compute_sim3, JaxLoopCloser.correct = compute_sim3, correct
    try:
        slam = JaxSystem(_cfg())
        states = []
        for d in frames:
            slam.track_stereo(d)
            states.append(slam.tracking.state.name)
    finally:
        JaxLoopCloser.compute_sim3, JaxLoopCloser.correct = \
            real_sim3, real_correct
    _, _, t_e = slam.tracking.trajectory_tum()
    return dict(states=states, closed=closed, snap=calls[0] if calls else None,
                ate=float(ate_rmse(t_e, twc[:len(t_e)])))


def _closer_state(lc):
    from types import SimpleNamespace
    import copy
    return SimpleNamespace(
        _consistent_groups=[(set(g), c) for g, c in lc._consistent_groups],
        _last_loop_kf=lc._last_loop_kf, n_loops_closed=lc.n_loops_closed,
        rng=copy.deepcopy(lc.rng))


@pytest.fixture(scope="module")
def port_run(orbit):
    _, _, twc, frames = orbit
    slam = System(config_from(_cfg()), device="cpu")
    states = []
    for d in frames:
        slam.track_stereo(d)
        states.append(slam.tracking.state.name)
    _, _, t_e = slam.tracking.trajectory_tum()
    return slam, states, float(ate_rmse(t_e, twc[:len(t_e)]))


def test_synthetic_world_is_pixel_equal(orbit):
    _, Rwc, twc, frames = orbit
    from airdos_tpu.io.synthetic import small_camera
    jworld = JaxWorld(cam=small_camera(), **WORLD)
    for i in (0, 47):
        want = jworld.frame(i, Rwc[i], twc[i], i * 0.2, with_humans=False)
        np.testing.assert_array_equal(frames[i].image_left, want.image_left)
        np.testing.assert_array_equal(frames[i].image_right,
                                      want.image_right)


def test_pillar_orbit_closes_the_loop_like_jax(jax_run, port_run):
    slam, states, ate = port_run
    assert all(s == "OK" for s in states), states
    lc = slam.loop_closer
    assert lc.n_loops_closed >= 1
    assert any(kf.loop_edges for kf in slam.map.kfs.values())
    assert ate < 0.15, ate
    assert all(s == "OK" for s in jax_run["states"])
    assert jax_run["closed"], "airdos_tpu closed no loop"
    assert lc.closed[0][:2] == jax_run["closed"][0]
    assert abs(ate - jax_run["ate"]) < 0.01, (ate, jax_run["ate"])
    assert slam.global_ba.n_runs == lc.n_loops_closed


def _share_equal(a, b):
    keys = set(a) | set(b)
    return sum(a.get(k) == b.get(k) for k in keys) / max(1, len(keys))


def test_compute_sim3_and_correct_match_jax_on_the_loop_snapshot(jax_run):
    snap = jax_run["snap"]
    assert snap is not None and "after" in snap
    cfg = config_from(_cfg())
    m = snap["map"]
    voc = vocabulary_from(snap["voc"], device="cpu")
    db = KeyFrameDatabase(voc, m)

    class _Ext:
        scales = tuple(1.2 ** i for i in range(cfg.orb.n_levels))
        sigma2 = np.asarray([s * s for s in scales], np.float32)

    ext = _Ext()
    lc = LoopCloser(cfg, m, db, ext, "cpu",
                    fuser=Fuser(cfg, m, ext, device="cpu"),
                    global_ba=GlobalBA(cfg, m, ext, device="cpu"))
    loop_closer_state_from(snap["closer"], lc)
    kf = m.kfs[snap["kf"]]
    res = lc.compute_sim3(kf, snap["cand"])
    want = snap["res"]
    assert res is not None
    np.testing.assert_allclose(res[0], want[0], atol=1e-3)
    np.testing.assert_allclose(res[1], want[1], atol=1e-3)
    assert res[4] == want[4]
    assert _share_equal(res[3], want[3]) >= 0.99
    assert len(set(res[5]) ^ set(want[5])) <= 0.01 * len(want[5])
    assert lc.correct(kf, res)
    after = snap["after"]
    for kid, jk in after.kfs.items():
        if jk.bad:
            continue
        tk = m.kfs[kid]
        np.testing.assert_allclose(tk.Rcw, jk.Rcw, atol=2e-3)
        np.testing.assert_allclose(tk.tcw, jk.tcw, atol=5e-3)
    live = np.nonzero(~after.points.bad[:after.points.n] &
                      ~m.points.bad[:after.points.n])[0]
    gap = np.linalg.norm(m.points.pos[live] - after.points.pos[live], axis=1)
    assert np.median(gap) < 5e-3, np.median(gap)
