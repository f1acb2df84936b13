"""The port's online mode (is_offline=False) on the CPU.

Exact parity with airdos_tpu on the same numpy inputs, for the pieces
that are deterministic:
- ``Tracking._need_new_keyframe`` with stubbed ``mapping_idle_fn`` /
  ``mapping_queue_len_fn``: both packages' functions, on one map and one
  frame from a port run, give the same decision over a grid of inlier
  counts, mapping states, queue lengths, frame gaps and schedules;
- ``Tracking._update_last_frame_vo_points``: the same temporary VO points
  (slots and positions equal) from the same last frame;
- ``HumanLocalBA`` with is_offline=False, called synchronously in both
  packages so that airdos_tpu's three-call online schedule runs on
  tests/test_torch_human.py's hand-built map: cameras within 2e-5 m,
  joints with an inlier projection edge within 1.5e-3 m (the human
  layer's stated tolerances, ROADMAP section 3), and ``launch`` + ``join`` bit-equal to the synchronous
  call;
- ``GlobalBA.launch`` + ``join`` with no concurrent writer: bit-equal to
  the synchronous ``GlobalBA()``.

Threaded mirrors of airdos_tpu's tests, held to their own bounds (online
runs are not byte-deterministic): tests/test_async_gba.py's single-device
cases, tests/test_system_e2e.py's online run, tests/test_config_flags.py's
reset and localization-only cases (online here, a reset also issued while
a global BA runs), and tests/test_online_human.py on the small camera.
How the online System keeps up with frames fed faster than its workers
run: the mapping pass skips fusion, the static BA and keyframe culling
while keyframes wait, and a human BA a whole cadence late makes tracking
wait for it.  The background global BA's steps wait out the tracking
thread's whole frame (the gate's frame, which an online System holds
around each frame).  Also: a worker's exception is raised by ``drain_mapping``, ``shutdown``
and the BAs' ``join``, and the state the threads share (the launch
counters, the vocabulary's one-time device upload, the span and event
logs) holds under many threads.
"""
import copy
import gc
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from airdos_tpu.slam import ba_driver as jbd
from airdos_tpu.slam.frame import Frame as JaxFrame
from airdos_tpu.slam.tracking import Tracking as JaxTracking
from airdos_tpu_torch.bow.vocabulary import train_vocabulary
from airdos_tpu_torch.config import SlamConfig
from airdos_tpu_torch.convert import config_from, map_from
from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld, small_camera
from airdos_tpu_torch.io.tum import ate_rmse
from airdos_tpu_torch.ops.cuda_build import LaunchCounter
from airdos_tpu_torch.slam import ba_driver as tbd
from airdos_tpu_torch.slam.loop_closing import LoopCloser
from airdos_tpu_torch.slam.map import KeyFrame
from airdos_tpu_torch.slam.system import System
from airdos_tpu_torch.slam.tracking import Tracking
from airdos_tpu_torch.utils import gate as gate_mod
from airdos_tpu_torch.utils.gate import TrackingGate, gap_waiter
from airdos_tpu_torch.utils.obs import EventLog, Profiler

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_async_gba import _build_map, _Ext as _GbaExt, _FakeFrame  # noqa: E402
from test_torch_human import (_Ext, _hand_built_maps,  # noqa: E402
                              assert_same_trajectories, human_config)
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)


def small_config(online: bool = True) -> SlamConfig:
    """tests/test_system_e2e.py's small_config in this package."""
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
    cfg.system.is_offline = not online
    return cfg


@pytest.fixture(scope="module")
def vo_frames():
    world = SyntheticStereoWorld(seed=0, n_points=200, cam=small_camera())
    return [(d, twc) for d, _, twc in
            world.sequence(14, dt=0.1, yaw_rate=0.008)]


@pytest.fixture(scope="module")
def tracked(vo_frames):
    """An offline port run over frames 0-7: its Tracking and last frame."""
    slam = System(small_config(online=False), device="cpu")
    for data, _ in vo_frames[:8]:
        frame = slam.track_stereo(data)
    slam.shutdown()
    return slam.tracking, frame


# ------------------------------------------------ deterministic parity
def _as_tracker(cls, trk: Tracking, **attrs):
    """A stand-in `self` for cls's host methods over the port tracker's
    map and state: both packages' functions read the same numpy arrays."""
    ns = SimpleNamespace(map=trk.map, th_depth=trk.th_depth,
                         max_frames=trk.max_frames, min_frames=0,
                         last_kf_id=trk.last_kf_id, **attrs)
    ns._tracked_close = lambda f: cls._tracked_close(ns, f)
    ns._kf_frame_index = lambda: cls._kf_frame_index(ns)
    return ns


@pytest.mark.parametrize("schedule", ["stereo_sharp", "reference"])
def test_need_new_keyframe_matches_airdos_tpu(tracked, schedule):
    trk, frame = tracked
    kf_index = trk.map.kfs[trk.last_kf_id].frame_id
    half = frame.mp_idx.copy()
    half[::2] = -1                      # fewer tracked close points
    decisions = []
    for mp_idx in (frame.mp_idx, half):
        for gap in (0, 1, 3, 6):
            fr = SimpleNamespace(depth=frame.depth, valid=frame.valid,
                                 mp_idx=mp_idx, outlier=frame.outlier,
                                 ref_kf_id=frame.ref_kf_id,
                                 index=kf_index + gap)
            for n_inliers in (10, 16, 40, 80, 150, 300, 600):
                for idle in (None, True, False):
                    for qlen in (0, 2, 3, 5):
                        attrs = dict(
                            config=SimpleNamespace(optimizer=SimpleNamespace(
                                kf_ref_schedule=schedule)),
                            n_inliers=n_inliers,
                            mapping_idle_fn=None if idle is None
                            else (lambda v=idle: v),
                            mapping_queue_len_fn=None if idle is None
                            else (lambda v=qlen: v))
                        got = Tracking._need_new_keyframe(
                            _as_tracker(Tracking, trk, **attrs), fr)
                        want = JaxTracking._need_new_keyframe(
                            _as_tracker(JaxTracking, trk, **attrs), fr)
                        assert got == want, (gap, n_inliers, idle, qlen)
                        decisions.append(got)
    # the grid reaches both answers and the busy-mapping branch
    assert any(decisions) and not all(decisions)


@pytest.mark.parametrize("case", ["localizing", "mapping", "keyframe"])
def test_vo_points_match_airdos_tpu(tracked, case):
    trk, frame = tracked
    lf = copy.copy(frame)
    lf.index = trk.map.kfs[trk.last_kf_id].frame_id + \
        (0 if case == "keyframe" else 1)
    lf.mp_idx = frame.mp_idx.copy()
    lf.mp_idx[1::3] = -1            # free slots with stereo depth
    jax_lf = SimpleNamespace(
        **{k: getattr(lf, k) for k in ("depth", "valid", "mp_idx",
                                       "ref_kf_id", "index")},
        unproject_feature=lambda i: JaxFrame.unproject_feature(lf, i))
    only = case != "mapping"
    port = _as_tracker(Tracking, trk, last_frame=lf, only_tracking=only)
    ref = _as_tracker(JaxTracking, trk, last_frame=jax_lf,
                      only_tracking=only)
    Tracking._update_last_frame_vo_points(port)
    JaxTracking._update_last_frame_vo_points(ref)
    assert sorted(port._vo_points) == sorted(ref._vo_points)
    for fid, pos in ref._vo_points.items():
        np.testing.assert_array_equal(port._vo_points[fid], pos)
    assert (len(port._vo_points) >= 100) == (case == "localizing")


def test_online_human_ba_schedule_matches_airdos_tpu():
    cfg, jm, tm = _hand_built_maps()
    cfg.system.is_offline = False
    jdrv = jbd.HumanLocalBA(cfg, jm, _Ext())
    assert jdrv._chunked
    jdrv(jm, 1)
    tdrv = tbd.HumanLocalBA(config_from(cfg), tm, _Ext(), device="cpu")
    assert tdrv._chunked
    tm2 = copy.deepcopy(tm)
    tdrv(tm, 1)
    assert tdrv.n_runs == 1 and jm.trajectories[0].optimized
    assert_same_trajectories(jm, tm, joint_tol=1.5e-3)
    for kid, jk in jm.kfs.items():
        assert np.abs(tm.kfs[kid].tcw - jk.tcw).max() < 2e-5
        assert np.abs(tm.kfs[kid].Rcw - jk.Rcw).max() < 2e-5
    # launch + join runs the same solve in its thread: bit-equal
    bg = tbd.HumanLocalBA(config_from(cfg), tm2, _Ext(), device="cpu")
    assert bg.launch(1)
    bg.join()
    assert bg.n_runs == 1
    for kid, k in tm.kfs.items():
        np.testing.assert_array_equal(tm2.kfs[kid].tcw, k.tcw)
    for tid, traj in tm.trajectories.items():
        for a, b in zip(traj.poses, tm2.trajectories[tid].poses):
            np.testing.assert_array_equal(a.joints_w, b.joints_w)


def _gba_maps(rng):
    cfg, jm, pts_gt, gt_tcw, _ = _build_map(rng)
    return config_from(cfg), map_from(jm), gt_tcw


def test_global_ba_launch_join_equals_synchronous(rng):
    cfg, m, _ = _gba_maps(rng)
    m2 = copy.deepcopy(m)
    tbd.GlobalBA(cfg, m, _GbaExt(), device="cpu")()
    gba = tbd.GlobalBA(cfg, m2, _GbaExt(), device="cpu")
    gba.launch(threading.Lock())
    gba.join()
    assert gba.n_runs == 1 and gba.n_aborted == 0
    for kid, k in m.kfs.items():
        np.testing.assert_array_equal(m2.kfs[kid].tcw, k.tcw)
        np.testing.assert_array_equal(m2.kfs[kid].Rcw, k.Rcw)
    np.testing.assert_array_equal(m2.points.pos, m.points.pos)


def test_online_loop_correction_equals_offline():
    """correct() online (the map lock released across SearchAndFuse's
    matches and the essential graph, the global BA launched in its
    thread) changes the map exactly as offline when nothing runs beside
    it: tests/test_loop_correction.py's drifted circle, every point of
    the map as the loop points."""
    from airdos_tpu_torch.slam.map import SlamMap
    from test_torch_loop_closing import _DummyDB, _drifted_circle, _extractor
    out = []
    for online in (False, True):
        m, res = _drifted_circle(KeyFrame, SlamMap)
        cfg = small_config(online=online)
        lock = threading.Lock() if online else None
        ext = _extractor()
        gba = tbd.GlobalBA(cfg, m, ext, device="cpu")
        lc = LoopCloser(cfg, m, _DummyDB(), ext, "cpu",
                        fuser=tbd.Fuser(cfg, m, ext, "cpu", map_lock=lock),
                        global_ba=gba, map_lock=lock)
        assert lc.async_gba == online
        if online:                      # the per-step waits, never held
            lc.gate = gba.gate = TrackingGate()
        assert lc.correct(m.kfs[23], res[:5] + (list(range(m.points.n)),))
        gba.join()
        assert gba.n_runs == 1
        out.append(b"".join(k.Rcw.tobytes() + k.tcw.tobytes()
                            for k in m.kfs.values()) +
                   m.points.pos[:m.points.n].tobytes() +
                   repr([sorted(o.items()) for o in m.points.obs]).encode())
    assert out[0] == out[1]


# ------------------------------------- tests/test_async_gba.py mirrors
def _centre_error(m, gt_tcw):
    return np.mean([np.linalg.norm(m.kfs[i].tcw - gt_tcw[i])
                    for i in range(1, 20)])


def test_async_gba_runs_and_improves(rng):
    cfg, m, gt_tcw = _gba_maps(rng)
    gba = tbd.GlobalBA(cfg, m, _GbaExt(), device="cpu")
    lock = threading.Lock()
    err_before = _centre_error(m, gt_tcw)
    gba.launch(lock, n_iters=20)
    # "tracking" keeps taking the lock while the solve runs: it never
    # waits for the whole solve
    max_wait = 0.0
    for _ in range(20):
        t0 = time.perf_counter()
        with lock:
            pass
        max_wait = max(max_wait, time.perf_counter() - t0)
        time.sleep(0.01)
    gba.join()
    err_after = _centre_error(m, gt_tcw)
    assert err_after < 0.5 * err_before, (err_before, err_after)
    assert max_wait < 2.0, max_wait


def test_new_keyframe_during_gba_gets_propagated(rng):
    cfg, m, _ = _gba_maps(rng)
    gba = tbd.GlobalBA(cfg, m, _GbaExt(), device="cpu")
    lock = threading.Lock()
    gba.launch(lock, n_iters=20)
    with lock:
        last = m.kfs[19]
        rel_t = np.array([0.0, 0.0, -0.25], np.float32)
        fr = _FakeFrame(20, 4, np.eye(3, dtype=np.float32),
                        (last.tcw + rel_t).astype(np.float32))
        kf_new = KeyFrame(20, fr)
        m.add_keyframe(kf_new)
        m.next_kf_id = 21
        kf_new.parent = 19
        last.children.add(20)
    gba.join()
    np.testing.assert_allclose(m.kfs[20].tcw - m.kfs[19].tcw, rel_t,
                               atol=1e-4)


def test_second_launch_aborts_first_without_deadlock(rng):
    cfg, m, gt_tcw = _gba_maps(rng)
    gba = tbd.GlobalBA(cfg, m, _GbaExt(), device="cpu")
    lock = threading.Lock()
    t0 = time.perf_counter()
    with lock:
        gba.launch(lock, n_iters=20)   # waits on the lock held here
        gba.launch(lock, n_iters=20)   # aborts the first: must not hang
    gba.join()
    assert time.perf_counter() - t0 < 120.0
    assert gba.n_aborted == 1 and gba.n_runs == 1
    assert np.isfinite(_centre_error(m, gt_tcw))


# ------------------------------------------------- online System mirrors
def test_online_mode_tracks_with_the_mapping_worker(vo_frames):
    """tests/test_system_e2e.py:67-75."""
    slam = System(small_config(), device="cpu")
    assert slam._map_thread.is_alive() and slam._map_thread.name == "mapping"
    for data, _ in vo_frames[:12]:
        slam.track_stereo(data)
    slam.shutdown()
    assert slam._map_thread is None
    assert slam.tracking.state.name == "OK"
    assert slam.map.n_keyframes() >= 2


def test_online_system_freezes_the_heap_until_shutdown(vo_frames):
    """Online, the objects alive when the System starts stay out of the
    garbage collector's scans until its shutdown; the holds nest; an
    offline System freezes nothing."""
    holds = gate_mod._frozen[0]
    System(small_config(online=False), device="cpu")
    assert gate_mod._frozen[0] == holds
    slam = System(small_config(), device="cpu")
    assert gate_mod._frozen[0] == holds + 1 and gc.get_freeze_count() > 0
    for data, _ in vo_frames[:2]:
        slam.track_stereo(data)
    gate_mod.freeze_heap()               # a second online System's hold
    slam.shutdown()
    assert gate_mod._frozen[0] == holds + 1 and gc.get_freeze_count() > 0
    slam.shutdown()                      # a second shutdown thaws nothing
    assert gate_mod._frozen[0] == holds + 1
    gate_mod.thaw_heap()
    assert gate_mod._frozen[0] == holds
    if holds == 0:
        assert gc.get_freeze_count() == 0
        gate_mod.thaw_heap()             # an unmatched thaw is a no-op
        assert gate_mod._frozen[0] == 0


def _waiter_returns(hook):
    """Run a step hook in a thread; the times it returned (perf_counter)
    in a list that fills when it returns."""
    returned = []

    def run():
        hook()
        returned.append(time.perf_counter())
    th = threading.Thread(target=run)
    th.start()
    return th, returned


def test_gap_waiter_takes_one_step_a_gap_between_whole_frames():
    """The background global BA's step hook: a step waits while the
    tracking thread is anywhere in its frame, also outside the device
    window; a second step waits for the next gap, or for the idle time
    when no frame comes; every wait is bounded; no gate, no hook."""
    gate = TrackingGate()
    hook = gap_waiter(gate, timeout=30.0, idle=0.5)
    with gate.frame():
        th, returned = _waiter_returns(hook)
        with gate:                      # the device window opens and ends
            time.sleep(0.05)
        time.sleep(0.2)                 # the rest of the frame
        assert not returned
        t_end = time.perf_counter()
    th.join(10.0)
    assert returned and returned[0] >= t_end
    # the same gap: the next step waits for the next frame's end
    th, returned = _waiter_returns(hook)
    time.sleep(0.1)
    assert not returned
    with gate.frame():
        time.sleep(0.05)
        assert not returned
        t_end = time.perf_counter()
    th.join(10.0)
    assert returned and returned[0] >= t_end
    # no frame comes: the idle time, from the last frame's end
    t0 = time.perf_counter()
    hook()
    assert 0.3 <= time.perf_counter() - t0 < 5.0
    # a frame that outlasts the wait
    short = gap_waiter(gate, timeout=0.1, idle=0.5)
    with gate.frame():
        t0 = time.perf_counter()
        short()
        assert 0.1 <= time.perf_counter() - t0 < 5.0
    assert gap_waiter(None) is None


def test_online_system_tracks_inside_the_frame_gate(vo_frames):
    """Online, each frame runs inside the tracking gate's frame, which is
    closed between frames and counts them; offline there is no gate."""
    slam = System(small_config(), device="cpu")
    gate = slam.tracking.device_gate
    inside = []
    track = slam.tracking.track

    def watched(data):
        inside.append(gate._in_frame)
        return track(data)
    slam.tracking.track = watched
    for data, _ in vo_frames[:3]:
        slam.track_stereo(data)
        assert not gate._in_frame
    slam.shutdown()
    assert inside == [True] * 3 and gate._ended == 3
    assert System(small_config(online=False),
                  device="cpu").tracking.device_gate is None


def test_online_reset_restarts_tracking(vo_frames):
    """tests/test_config_flags.py:48-68 online, and a second reset issued
    while a global BA runs: the BA is aborted, nothing is written into the
    cleared map, and tracking starts again."""
    slam = System(small_config(), device="cpu")
    for data, _ in vo_frames[:6]:
        slam.track_stereo(data)
    assert slam.map.n_keyframes() >= 1
    for start, with_gba in ((6, True), (10, False)):
        if with_gba:
            assert slam.drain_mapping()
            slam.global_ba.launch(slam._map_lock)
        slam.reset()
        assert slam.global_ba._thread is None
        assert slam.map.n_keyframes() == 0
        assert slam.tracking.state.name == "NOT_INITIALIZED"
        assert slam.tracking.records == []
        for data, _ in vo_frames[start:start + 4]:
            slam.track_stereo(data)
        assert slam.tracking.state.name == "OK"
        assert slam.map.n_keyframes() >= 1
    slam.shutdown()
    assert slam.global_ba.n_runs + slam.global_ba.n_aborted == 1


def test_online_localization_only_mode(vo_frames):
    """tests/test_config_flags.py:164-186 online: the map is frozen."""
    slam = System(small_config(), device="cpu")
    for data, _ in vo_frames[:8]:
        slam.track_stereo(data)
    assert slam.drain_mapping()
    n_kfs, n_pts = slam.map.n_keyframes(), slam.map.n_points()
    assert slam.tracking.state.name == "OK"
    slam.activate_localization_mode()
    for data, twc in vo_frames[8:]:
        frame = slam.track_stereo(data)
        assert slam.tracking.state.name == "OK"
    assert slam.drain_mapping()
    assert slam.map.n_keyframes() == n_kfs
    assert slam.map.n_points() == n_pts
    assert np.linalg.norm(frame.Ow - twc) < 0.5
    slam.deactivate_localization_mode()
    slam.shutdown()


def test_online_human_ba_runs_in_the_background():
    """tests/test_online_human.py on the small camera (seed 3, two
    humans, Camera.fps 3): the human BA runs through launch() while the
    mapping worker maps, and accuracy holds."""
    cfg = config_from(human_config())
    cfg.camera.fps = 3.0
    cfg.system.is_offline = False
    world = SyntheticStereoWorld(seed=3, n_points=200, n_humans=2,
                                 cam=cfg.camera)
    frames = list(world.sequence(14, dt=0.1, yaw_rate=0.008))
    slam = System(cfg, device="cpu")
    launched = []
    real = slam.human_ba.launch
    slam.human_ba.launch = lambda kf_id: launched.append(real(kf_id)) or \
        launched[-1]
    for data, _, _ in frames:
        slam.track_stereo_human(data)
    assert slam.tracking.state.name == "OK"
    slam.shutdown()                    # raises what a background solve did
    assert launched.count(True) >= 2 and slam.human_ba.n_runs >= 2
    assert slam.map.optimized_track_ids
    _, _, twc_e = slam.tracking.trajectory_tum()
    gt = np.asarray([t for _, _, t in frames])
    assert ate_rmse(twc_e, gt[:len(twc_e)]) < 0.03


@pytest.mark.parametrize("waiting", [False, True])
def test_mapping_pass_skips_refinement_while_keyframes_wait(vo_frames,
                                                            waiting):
    """Online, the mapping pass of a keyframe skips fusion, the static BA
    and keyframe culling while more keyframes are queued (the reference's
    LocalMapping::Run under CheckNewKeyFrames), and runs them all once the
    queue is empty."""
    slam = System(small_config(), device="cpu")
    for data, _ in vo_frames[:4]:
        slam.track_stereo(data)
    slam.shutdown()                    # the worker stops; the queue stays
    calls = []
    lm = slam.local_mapper
    for name in ("create_new_points", "fuse_neighbors", "cull_keyframes"):
        setattr(lm, name, lambda *a, name=name: calls.append(name))
    slam.static_ba = lambda kf: calls.append("static_ba")
    slam.map.n_keyframes = lambda: 3
    if waiting:
        slam._map_queue.put(object())
    slam._mapping_pipeline(slam.map.kfs[slam.tracking.last_kf_id])
    full = ["create_new_points", "fuse_neighbors", "static_ba",
            "cull_keyframes"]
    assert calls == (["create_new_points"] if waiting else full)


def test_online_human_ba_a_cadence_late_makes_tracking_wait(vo_frames):
    """Online, a human BA tick that finds the last solve running is
    skipped, until the solve is a whole cadence period late: then tracking
    joins it and launches the next, so the solves keep the cadence of a
    tracker that outruns them."""
    cfg = small_config()
    cfg.camera.fps = 2.0                     # a tick every 2 frames
    cfg.optimizer.is_static_only = False
    slam = System(cfg, device="cpu")
    events, running = [], [False]

    class Solve:                             # a solve that never ends
        def launch(self, kf_id):             # until it is joined
            ok = not running[0]
            running[0] = True
            events.append(("launch", slam._frame_count, ok))
            return ok

        def join(self):
            running[0] = False
            events.append(("join", slam._frame_count))
    slam.human_ba = Solve()
    slam.map.long_trajectories = lambda: [0]
    for data, _ in vo_frames[:12]:
        slam.track_stereo(data)
        assert slam.tracking.state.name == "OK"
    slam.shutdown()
    assert events == [
        ("launch", 2, True), ("launch", 4, False), ("launch", 5, False),
        ("join", 6), ("launch", 6, True), ("launch", 8, False),
        ("launch", 9, False), ("join", 10), ("launch", 10, True),
        ("join", 12)]                          # the last is shutdown's


# ------------------------------------------------------------ faults
def test_a_worker_exception_is_raised_not_swallowed(vo_frames):
    def boom(*args):
        raise RuntimeError("boom")

    for finish in ("drain_mapping", "shutdown"):
        slam = System(small_config(), device="cpu")
        slam.local_mapper.cull_map_points = boom
        for data, _ in vo_frames[:4]:
            slam.track_stereo(data)
        with pytest.raises(RuntimeError, match="boom"):
            getattr(slam, finish)()
        slam.shutdown()                 # the error was raised once


def test_background_ba_exceptions_reach_join(rng):
    cfg, m, _ = _gba_maps(rng)
    gba = tbd.GlobalBA(cfg, m, _GbaExt(), device="cpu")
    gba._assemble = lambda: 1 / 0
    gba.launch(threading.Lock())
    with pytest.raises(ZeroDivisionError):
        gba.join()
    cfg_h, _, tm = _hand_built_maps()
    hba = tbd.HumanLocalBA(config_from(cfg_h), tm, _Ext(), device="cpu")
    hba._assemble = lambda kf_id: 1 / 0
    assert hba.launch(1)
    with pytest.raises(ZeroDivisionError):
        hba.join()
    hba.join()                          # raised once


# ----------------------------------------------- shared state, hammered
@pytest.fixture
def fast_switching():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _hammer(fn, n_threads=16):
    start = threading.Barrier(n_threads)
    out = [None] * n_threads

    def body(i):
        start.wait()
        out[i] = fn(i)

    ths = [threading.Thread(target=body, args=(i,), name=f"w{i}")
           for i in range(n_threads)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=60)
        assert not t.is_alive()
    return out


def test_launch_counter_loses_no_update(fast_switching):
    c = LaunchCounter()
    _hammer(lambda i: [c.count(i % 2) for _ in range(2000)])
    assert c.total == 16 * 2000
    assert c.tally() == {(f"w{i}", i % 2): 2000 for i in range(16)}
    c.reset()
    assert c.total == 0 and c.tally() == {}


def test_vocabulary_device_tables_upload_once(fast_switching, monkeypatch):
    rng = np.random.default_rng(0)
    voc = train_vocabulary(rng.integers(0, 256, (600, 32), dtype=np.uint8),
                           k=4, depth=2, device="cpu")
    uploads = []
    from_numpy = torch.from_numpy

    def slow_upload(a):              # an upload that yields the GIL
        uploads.append(a.shape)
        time.sleep(0.01)
        return from_numpy(a)

    voc._tables = None                   # training uploaded them already
    monkeypatch.setattr(torch, "from_numpy", slow_upload)
    tables = _hammer(lambda i: voc._device_tables())
    monkeypatch.undo()
    assert len(uploads) == 4             # the four tables, once
    assert all(t is tables[0] for t in tables)
    voc2 = copy.deepcopy(voc)           # the lock is remade in a copy
    assert voc2._device_tables()[0].equal(tables[0][0])


def test_spans_and_events_from_many_threads(fast_switching):
    prof, log = Profiler(), EventLog()

    def body(i):
        for j in range(500):
            prof.add(f"s{j % 3}", 1e-3)
            log.emit("e", i=i, j=j)

    log.ring = type(log.ring)(maxlen=16 * 500)
    _hammer(body)
    assert sum(v["n"] for v in prof.report().values()) == 16 * 500
    assert len(log.events("e")) == 16 * 500
