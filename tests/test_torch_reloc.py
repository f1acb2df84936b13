"""Relocalization and map checkpoints in the port against airdos_tpu
(CPU): tests/test_relocalization.py's blackout (small camera, 18 good
frames, 3 blank, 5 held at the last pose) through both packages on the
same rendered frames.  Stated tolerances:

- the port: state OK at the end, the relocalizing frame >= 21 and equal
  to airdos_tpu's, no TUM step > 0.12 m (tests/test_relocalization.py's
  bounds), and the relocalized frames' camera centres within 5e-3 m of
  airdos_tpu's (the maps going into the blackout differ by float32
  rounding of 18 frames of tracking and mapping, ~1e-5 m; the EPnP
  samples are the same draws, and the pose LM that follows the RANSAC
  settles both within its own noise of ~1e-3 m).
- save_map / load_map: a map written by the port and one written by
  airdos_tpu's save_map load in the port with equal keyframe poses,
  points and observations (exactly); a fresh port System that loads
  either starts LOST and relocalizes on the next frame.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

from airdos_tpu.config import SlamConfig
from airdos_tpu.io.synthetic import small_camera
from airdos_tpu.slam.system import System as JaxSystem
from airdos_tpu_torch.convert import config_from
from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
from airdos_tpu_torch.io.synthetic import small_camera as t_small_camera
from airdos_tpu_torch.slam.map import load_map
from airdos_tpu_torch.slam.system import System

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)

N_GOOD, N_BLANK, N_RECOVER = 18, 3, 5


def _cfg():
    cfg = SlamConfig()
    cfg.camera = small_camera()
    cfg.orb.n_features = 600
    cfg.orb.n_levels = 4
    cfg.system.is_offline = True
    cfg.device.max_keypoints = 1024
    cfg.device.max_local_kfs = 8
    cfg.device.max_fixed_kfs = 4
    cfg.device.max_local_points = 1024
    cfg.device.max_ba_edges = 4096
    return cfg


@pytest.fixture(scope="module")
def blackout():
    world = SyntheticStereoWorld(seed=0, n_points=200, cam=t_small_camera())
    Rwc, twc = world.trajectory(N_GOOD, dt=0.1, speed=0.35, yaw_rate=0.012)
    poses = list(zip(Rwc, twc)) + [(Rwc[-1], twc[-1])] * (N_BLANK + N_RECOVER)
    frames = [world.frame(i, R, t, i * 0.1, with_humans=False)
              for i, (R, t) in enumerate(poses)]
    for i in range(N_GOOD, N_GOOD + N_BLANK):
        frames[i] = dataclasses.replace(
            frames[i], image_left=np.zeros_like(frames[i].image_left),
            image_right=np.zeros_like(frames[i].image_right))
    return frames


def _run(slam, frames):
    states = []
    for d in frames:
        slam.track_stereo(d)
        states.append(slam.tracking.state.name)
    return states


@pytest.fixture(scope="module")
def jax_run(blackout, tmp_path_factory):
    slam = JaxSystem(_cfg())
    states = _run(slam, blackout)
    path = tmp_path_factory.mktemp("jax_map") / "map.npz"
    slam.save_map(path)
    _, _, t_e = slam.tracking.trajectory_tum()
    return dict(states=states, reloc=slam.tracking.last_reloc_frame,
                t=t_e, map_path=path, map=slam.map)


@pytest.fixture(scope="module")
def port_run(blackout):
    slam = System(config_from(_cfg()), device="cpu")
    states = _run(slam, blackout)
    return slam, states


def test_blackout_relocalizes_like_jax(jax_run, port_run):
    slam, states = port_run
    assert states[N_GOOD - 1] == "OK" and states[N_GOOD] == "LOST"
    assert states[-1] == "OK", states
    reloc = slam.tracking.last_reloc_frame
    assert reloc >= N_GOOD + N_BLANK, reloc
    assert reloc == jax_run["reloc"]
    assert jax_run["states"] == states
    _, _, t_e = slam.tracking.trajectory_tum()
    steps = np.linalg.norm(np.diff(t_e, axis=0), axis=1)
    assert steps.max() < 0.12, steps.max()
    after = slice(int(reloc), None)
    gap = np.linalg.norm(t_e[after] - jax_run["t"][after], axis=1)
    assert gap.max() < 5e-3, gap
    assert slam.tracking.reloc_tried >= 1


def _assert_same_map(tm, jm):
    assert sorted(tm.kfs) == sorted(jm.kfs)
    for kid, jk in jm.kfs.items():
        tk = tm.kfs[kid]
        np.testing.assert_array_equal(tk.Rcw, jk.Rcw)
        np.testing.assert_array_equal(tk.tcw, jk.tcw)
        np.testing.assert_array_equal(tk.mp_idx, jk.mp_idx)
        assert tk.loop_edges == jk.loop_edges and tk.bad == jk.bad
    n = jm.points.n
    assert tm.points.n == n
    np.testing.assert_array_equal(tm.points.pos[:n], jm.points.pos[:n])
    assert tm.points.obs[:n] == jm.points.obs[:n]


@pytest.mark.parametrize("writer", ["port", "airdos_tpu"])
def test_load_map_then_relocalize(writer, jax_run, port_run, blackout,
                                  tmp_path):
    if writer == "port":
        path = tmp_path / "map.npz"
        port_run[0].save_map(path)
        _assert_same_map(load_map(path), port_run[0].map)
    else:
        path = jax_run["map_path"]
        _assert_same_map(load_map(path), jax_run["map"])
    slam = System(config_from(_cfg()), device="cpu")
    slam.load_map(path)
    assert slam.tracking.state.name == "LOST"
    frame = blackout[-1]
    slam.track_stereo(frame)
    assert slam.tracking.state.name == "OK"
    assert slam.tracking.last_reloc_frame == frame.index
    Ow = slam.tracking.last_frame.Ow
    assert np.linalg.norm(Ow - port_run[0].tracking.last_frame.Ow) < 0.02
