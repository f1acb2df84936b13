"""The port's offline human System against airdos_tpu (CPU).

Both packages track the same numpy frames: the small camera, seed 3, two
humans, masked extraction, Camera.fps 3 (a human BA every 3 frames: three
solves in 10 frames).  Stated tolerances:

- per frame the same state and branch; the same keyframes and human BA
  solve count; camera trajectory within 1e-4 m;
- the same trajectory ids, pose counts, reference keyframes and
  keyframe/frame origin of every pose, and the same optimized tracks;
- after the first human BA solve: joints with a projection edge within
  5e-3 m, as in tests/test_torch_human.py's driver test; the other
  joints within 0.5 m, the outlier flags equal on >= 95% of their
  entries.  A rigidity or motion edge of a weakly held joint (no
  projection edge) has a residual that follows that joint, so its
  chi-square test can fall on either side of the threshold (one limb of
  one trajectory here), and the joints on that limb then settle up to
  0.4 m apart (the port on the card against the port on the CPU: 0.43
  m on these frames);
- at the end of the run the HMTraj/Motion dumps hold the same lines
  (track, pose, joint, timestamp), and the joints' median gap is within
  0.1 m.  Later solves start from the earlier ones' weakly held joints
  (no projection edge: rigidity, motion and damping only), so rounding
  grows there: airdos_tpu against itself, with the first solve's start
  moved by 1e-5 m, ends with a median joint gap of 0.055 m (p90 0.36 m,
  max 1.2 m) on these frames.  The gap is the problem's conditioning, not
  the port's; the single-solve tests bound the solver.

Also: two port runs byte-identical (TUM, KF/MP/Match/HMTraj/Motion), and
the ports of tests/test_config_flags.py's human cases (the depth-image
path, Optimizer.IsKeyFrameOnly, use_fast_human_ba), which run on the
port only and are fast here.
"""
import copy
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from airdos_tpu.slam.system import System as JaxSystem
from airdos_tpu_torch.convert import config_from
from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
from airdos_tpu_torch.slam.system import System

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_human import assert_same_trajectories, human_config  # noqa: E402
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)

N_FRAMES = 10
DUMPS = ("KF.txt", "MP.txt", "Match.txt", "HMTraj.txt", "Motion.txt")


def flagship_config():
    cfg = human_config()
    cfg.camera.fps = 3.0
    return cfg


@pytest.fixture(scope="module")
def frames():
    world = SyntheticStereoWorld(seed=3, n_points=200, n_humans=2,
                                 cam=config_from(flagship_config()).camera)
    return [(d, twc) for d, _, twc in
            world.sequence(N_FRAMES, dt=0.1, yaw_rate=0.008)]


def _run(slam, frames, out_dir):
    """Track the frames; per frame (state, branch); the trajectories
    right after the first human BA write-back; the dumps."""
    first = {}
    write_back = slam.human_ba._write_back

    def snapshot(problem, res):
        write_back(problem, res)
        if not first:
            first["map"] = SimpleNamespace(
                trajectories=copy.deepcopy(slam.map.trajectories),
                optimized_track_ids=set(slam.map.optimized_track_ids))
    slam.human_ba._write_back = snapshot
    per = []
    for data, _ in frames:
        slam.track_stereo_human(data)
        per.append((slam.tracking.state.name, slam.tracking.last_branch))
    slam.save_trajectory_tum(out_dir / "traj.txt")
    slam.before_end(out_dir)
    slam.shutdown()
    return dict(slam=slam, per=per, first=first["map"],
                files={f: (out_dir / f).read_bytes()
                       for f in ("traj.txt",) + DUMPS})


@pytest.fixture(scope="module")
def jax_run(frames, tmp_path_factory):
    return _run(JaxSystem(flagship_config()), frames,
                tmp_path_factory.mktemp("jax"))


@pytest.fixture(scope="module")
def port_run(frames, tmp_path_factory):
    return _run(System(config_from(flagship_config()), device="cpu"),
                frames, tmp_path_factory.mktemp("port"))


def test_human_system_tracks_like_jax(jax_run, port_run, frames):
    js, ts = jax_run["slam"], port_run["slam"]
    assert port_run["per"] == jax_run["per"]
    assert all(s == "OK" for s, _ in port_run["per"])
    assert ts.map.n_keyframes() == js.map.n_keyframes()
    assert ts.human_ba.n_runs == js.human_ba.n_runs >= 2
    _, _, t_j = js.tracking.trajectory_tum()
    _, _, t_t = ts.tracking.trajectory_tum()
    assert np.abs(t_t - t_j).max() < 1e-4
    rep = ts.profiler.report()
    assert rep["human_ba"]["n"] == ts.human_ba.n_runs
    for stage in ("hba.assemble", "hba.solve", "hba.writeback"):
        assert rep[stage]["n"] == ts.human_ba.n_runs, stage


def test_human_system_first_solve_matches_jax(jax_run, port_run):
    assert_same_trajectories(jax_run["first"], port_run["first"],
                             other_tol=0.5, flag_share=0.95)


def test_human_system_trajectories_and_dumps_match_jax(jax_run, port_run):
    jm, tm = jax_run["slam"].map, port_run["slam"].map
    assert sorted(tm.trajectories) == sorted(jm.trajectories)
    assert tm.optimized_track_ids == jm.optimized_track_ids
    gaps = []
    for tid, jt in jm.trajectories.items():
        tt = tm.trajectories[tid]
        assert len(tt) == len(jt) and tt.optimized == jt.optimized
        for a, b in zip(tt.poses, jt.poses):
            assert (a.kf_id, a.in_keyframe, a.timestamp) == \
                (b.kf_id, b.in_keyframe, b.timestamp)
            np.testing.assert_array_equal(a.optimized, b.optimized)
            gaps.append(np.linalg.norm(a.joints_w - b.joints_w, axis=1))
    assert np.median(np.concatenate(gaps)) < 0.1
    for name, cols in (("HMTraj.txt", 4), ("Motion.txt", 1)):
        want = jax_run["files"][name].decode().splitlines()
        got = port_run["files"][name].decode().splitlines()
        assert len(got) == len(want) > 0
        assert [ln.split()[:cols] for ln in got] == \
            [ln.split()[:cols] for ln in want]
    n_lines = sum(len(t.poses) * 18 for t in tm.trajectories.values())
    assert len(port_run["files"]["HMTraj.txt"].splitlines()) == n_lines


def test_port_human_runs_are_byte_identical(frames, port_run, tmp_path):
    again = _run(System(config_from(flagship_config()), device="cpu"),
                 frames, tmp_path)
    for name, data in port_run["files"].items():
        assert again["files"][name] == data, name


# ------------------------------------------- tests/test_config_flags.py
def _flags_config(**optimizer):
    cfg = human_config()
    cfg.system.is_mask = False
    cfg.human.is_seg = False
    for k, v in optimizer.items():
        setattr(cfg.optimizer, k, v)
    return config_from(cfg)


def _human_world(cfg):
    return SyntheticStereoWorld(seed=3, n_points=200, cam=cfg.camera,
                                n_humans=1)


def test_ground_truth_depth_human_path():
    """System.IsGroundTruthDepth with a depth image: joint depths come
    from the depth map (Frame::ComputeHumanPoseDepth, Frame.cc:249-311)
    instead of stereo triangulation."""
    cfg = _flags_config()
    cfg.system.is_ground_truth_depth = True
    world = _human_world(cfg)
    slam = System(cfg, device="cpu")
    seen = 0
    Rwc, twc = world.trajectory(6, 0.1)
    for i in range(6):
        data = world.frame(i, Rwc[i], twc[i], i * 0.1, with_depth=True)
        frame = slam.track_stereo_human(data)
        for obs in frame.humans:
            seen += 1
            for j in range(0, 18, 4):
                u, v = obs.kp_left[j]
                ui = int(np.clip(u, 0, data.depth.shape[1] - 1))
                vi = int(np.clip(v, 0, data.depth.shape[0] - 1))
                d = max(float(data.depth[vi, ui]), 0.01)
                assert abs(obs.depth[j] - d) < 1e-4
    assert seen > 0
    slam.shutdown()


def test_keyframe_only_limits_human_poses():
    """Optimizer.IsKeyFrameOnly: human poses enter only on keyframes
    (reference Tracking.cc:493)."""
    counts = {}
    for kf_only in (False, True):
        cfg = _flags_config(is_keyframe_only=kf_only)
        slam = System(cfg, device="cpu")
        for data, _, _ in _human_world(cfg).sequence(10, dt=0.1,
                                                     yaw_rate=0.008):
            slam.track_stereo_human(data)
        poses = [hp for t in slam.map.trajectories.values()
                 for hp in t.poses]
        counts[kf_only] = len(poses)
        if kf_only:
            assert all(hp.in_keyframe for hp in poses)
        slam.shutdown()
    assert 1 <= counts[True] < counts[False]


def test_fast_human_ba_uses_whole_trajectory():
    """use_fast_human_ba: every pose of an observed trajectory enters the
    BA window (Optimizer.cc:736-1493); the windowed variant marks only the
    poses anchored to window keyframes."""
    n_opt = {}
    for fast in (False, True):
        cfg = _flags_config(use_fast_human_ba=fast)
        slam = System(cfg, device="cpu")
        for data, _, _ in _human_world(cfg).sequence(16, dt=0.1,
                                                     yaw_rate=0.008):
            slam.track_stereo_human(data)
        trajs = [t for t in slam.map.trajectories.values() if t.optimized]
        assert trajs and slam.human_ba.n_runs >= 1
        t0 = trajs[0]
        n_opt[fast] = sum(bool(hp.optimized.any()) for hp in t0.poses)
        if fast:
            assert n_opt[fast] >= min(len(t0),
                                      cfg.device.max_trajectory_len) * 0.6
        slam.shutdown()
    assert n_opt[True] >= n_opt[False]
