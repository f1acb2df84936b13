"""The port's human layer against airdos_tpu, module by module (CPU).

Both packages get the same numpy inputs.  Stated tolerances:

- patch_disparity / disparity_bm on rendered crowd frames and on periodic
  images whose SADs tie: the same integer argmin (first minimum) and the
  same invalid (-1) slots; disparities within 1e-5.  SADs of 8-bit images
  are integer sums, exact in float32 in both packages.
- the frame's human observations (stereo association and the depth-image
  path): the same track ids and bad flags, keypoints equal, depths within
  1e-6 (host numpy in both packages, fed the probed disparities).
- human_bundle_adjust on tests/test_human_ba.py's problems (clean, broken
  motion, a bad joint, use_huber=False): the four inlier-flag arrays
  equal; cameras within 1e-5 m, static points within 1e-4 m, motion
  velocities within 2e-4 m/s, limb lengths within 2e-3 m, joints within
  1e-2 m (median within 1e-4 m).  The joints at the far end are the
  poorly constrained ones (the depth axis of a 14-joint skeleton at 8 m
  seen through 0.5 px noise): a float64 run of the port lies as far from
  airdos_tpu's float32 run there (6.9e-3 m against 6.0e-3 m for float32),
  so these bounds sit at float32's floor, not above it.
- the human families' compact scatter: equal to jnp .at[].add on
  duplicate indices within 1e-6 relative, and bit-equal between its plain
  version and a second call; 60 segment sums a solve (4 a step).
- one HumanLocalBA call on the same hand-built map: the same
  trajectories, flags and observations; keyframe poses within 1e-5 m,
  joints with a projection edge within 5e-3 m, all joints within 0.25 m
  (joints of poses outside a keyframe have no projection edge and are
  held only by rigidity, motion and damping: a float64 run of the port
  lies 0.15 m from airdos_tpu's float32 one there), limb lengths within
  2e-3 m, motions within 1e-3 m/s.
- map_from, select_window_trajectories and the text readers: equal.
"""
import copy
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airdos_tpu.config as jcfg
from airdos_tpu.io import datasets as jds
from airdos_tpu.io.synthetic import small_camera
from airdos_tpu.ops.disparity import disparity_bm as jax_disparity_bm
from airdos_tpu.ops.disparity import patch_disparity as jax_patch_disparity
from airdos_tpu.slam import ba_driver as jbd
from airdos_tpu.slam.frame import FrontEnd as JaxFrontEnd
from airdos_tpu.slam.map import HumanPose as JaxHumanPose
from airdos_tpu.slam.map import HumanTrajectory as JaxHumanTrajectory
from airdos_tpu.slam.map import KeyFrame as JaxKeyFrame
from airdos_tpu.slam.map import SlamMap as JaxMap
from airdos_tpu_torch.convert import config_from, map_from
from airdos_tpu_torch.io import datasets as tds
from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
from airdos_tpu_torch.ops.disparity import disparity_bm, patch_disparity
from airdos_tpu_torch.ops.segment_kernels import (make_compact_segments,
                                                  segment_sum,
                                                  segment_sum_ref)
from airdos_tpu_torch.slam import ba_driver as tbd
from airdos_tpu_torch.slam.frame import FrontEnd, torso_pixels
from airdos_tpu_torch.solvers import human_ba as thba

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_human_ba import SKEL, build_problem, run_ba  # noqa: E402
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)

N_PARTS = 14


def _t(x):
    return torch.from_numpy(np.array(x))


def human_config(**flags):
    """The small camera with the human layer on (masked extraction)."""
    cfg = jcfg.SlamConfig()
    cfg.camera = small_camera()
    cfg.orb.n_features = 600
    cfg.orb.n_levels = 4
    cfg.device.max_keypoints = 1024
    cfg.device.max_local_kfs = 8
    cfg.device.max_fixed_kfs = 4
    cfg.device.max_local_points = 1024
    cfg.device.max_ba_edges = 4096
    cfg.device.max_trajectories = 2
    cfg.device.max_trajectory_len = 16
    cfg.human.ok = True
    cfg.human.is_seg = True
    cfg.system.is_mask = True
    for k, v in flags.items():
        setattr(cfg.system, k, v)
    return cfg


@pytest.fixture(scope="module")
def crowd_frames():
    world = SyntheticStereoWorld(seed=2, n_points=300, n_humans=4,
                                 crowd=True, cam=small_camera())
    Rwc, twc = world.trajectory(3, 0.1, yaw_rate=0.005)
    return [world.frame(i, Rwc[i], twc[i], i * 0.1, with_humans=True,
                        with_depth=True) for i in range(3)]


# ------------------------------------------------------------ disparity
def _u8(im):
    """An image as the frame step sees it: uint8, cast to float32 on the
    device."""
    return np.asarray(im).astype(np.uint8).astype(np.float32)


def _disparity_pair(imL, imR, px):
    imL, imR = _u8(imL), _u8(imR)
    ref = np.asarray(jax_patch_disparity(jnp.asarray(imL), jnp.asarray(imR),
                                         jnp.asarray(px)))
    out = patch_disparity(_t(imL), _t(imR), _t(px)).numpy()
    return out, ref


def _assert_same_disparity(out, ref):
    np.testing.assert_array_equal(out < 0, ref < 0)
    ok = ref >= 0
    # the integer part is the argmin: the same on both sides
    np.testing.assert_array_equal(np.round(out[ok]), np.round(ref[ok]))
    np.testing.assert_allclose(out[ok], ref[ok], atol=1e-5, rtol=0)


def test_patch_disparity_matches_jax_on_crowd_frames(crowd_frames):
    n_valid = 0
    for d in crowd_frames:
        px = torso_pixels(d.humans_left)
        # out-of-image and uncovered probes too: off the image, and so
        # close to its left edge that no window is covered
        px[-3:] = [[-5.0, 10.0], [400.0, 30.0], [3.0, 100.0]]
        out, ref = _disparity_pair(d.image_left, d.image_right, px)
        _assert_same_disparity(out, ref)
        assert (out[-3:] == -1).all()
        n_valid += int((ref >= 0).sum())
    assert n_valid >= 10, n_valid


def test_patch_disparity_takes_the_first_of_tied_minima():
    """A texture that repeats every 16 px gives SAD minima at d, d + 16,
    d + 32: both packages take the first.  Half-pixel probes round half
    to even in both."""
    rng = np.random.default_rng(4)
    tile = rng.integers(0, 255, (60, 16)).astype(np.float32)
    imL = np.tile(tile, (1, 8))                     # [60, 128]
    imR = np.roll(imL, -5, axis=1)                   # true disparity 5
    px = np.array([[100.0, 30.0], [90.5, 20.5], [101.5, 40.0],
                   [60.0, 29.5], [127.0, 59.0]], np.float32)
    out, ref = _disparity_pair(imL, imR, px)
    _assert_same_disparity(out, ref)
    assert np.all(np.round(out[:4]) == 5), out


def test_disparity_bm_matches_jax(crowd_frames):
    d = crowd_frames[0]
    imL = _u8(d.image_left[60:140, 100:260])
    imR = _u8(d.image_right[60:140, 100:260])
    ref = np.asarray(jax_disparity_bm(jnp.asarray(imL), jnp.asarray(imR)))
    out = disparity_bm(_t(imL), _t(imR)).numpy()
    assert out.shape == ref.shape == imL.shape
    _assert_same_disparity(out, ref)
    assert (ref >= 0).mean() > 0.2


# --------------------------------------------------- human observations
@pytest.mark.parametrize("gt_depth", [False, True])
def test_frame_human_observations_match_jax(crowd_frames, gt_depth):
    """The stereo association (_associate_humans, on the probed torso
    disparities) and the depth-image path (_humans_from_depth)."""
    cfg = human_config(is_ground_truth_depth=gt_depth)
    jfe, tfe = JaxFrontEnd(cfg), FrontEnd(config_from(cfg), device="cpu")
    n = 0
    for d in crowd_frames[:2]:
        if not gt_depth:
            d = copy.copy(d)
            d.depth = None
        jf, tf = jfe.build_frame(d), tfe.build_frame(d)
        assert [h.track_id for h in tf.humans] == \
            [h.track_id for h in jf.humans]
        for a, b in zip(tf.humans, jf.humans):
            np.testing.assert_array_equal(a.bad, b.bad)
            np.testing.assert_array_equal(a.kp_left, b.kp_left)
            np.testing.assert_array_equal(a.kp_right, b.kp_right)
            np.testing.assert_allclose(a.depth, b.depth, rtol=1e-6)
            np.testing.assert_allclose(tf.unproject_human(a),
                                       jf.unproject_human(b), atol=1e-4)
        n += len(tf.humans)
        # the masked extraction: the same features, none on a human
        assert np.mean(tf.valid == jf.valid) > 0.99
    assert n >= 4, n


# ------------------------------------------------------------ human BA
def _run_port(pr, use_huber=True):
    T, L, P, Es = pr["T"], pr["L"], pr["P"], pr["Es"]
    ones = np.ones((T, L, N_PARTS), bool)
    pts0 = pr["pts_gt"] + 0.05 * np.random.default_rng(1).standard_normal(
        (P, 3)).astype(np.float32)
    return thba.human_bundle_adjust(
        _t(pr["cam_R"]), _t(pr["cam_t"]), _t(pr["cam_fixed"]), _t(pts0),
        torch.ones(P, dtype=torch.bool), _t(pr["es_cam"]), _t(pr["es_pt"]),
        _t(pr["es_obs"]), torch.ones(Es), torch.ones(Es, dtype=torch.bool),
        _t(pr["joints0"]), _t(ones), _t(pr["jo_cam"]), _t(pr["jo_obs"]),
        _t(ones), _t(pr["seg0"]), torch.ones((T, N_PARTS), dtype=torch.bool),
        torch.ones((T, L, N_PARTS), dtype=torch.bool),
        torch.eye(3).repeat(T, 1, 1), torch.zeros((T, 3)),
        torch.ones(T, dtype=torch.bool), _t(pr["pose_dt"]),
        torch.ones((T, L, 5), dtype=torch.bool),
        1.0, 0.5, 20.0, 20.0, 1.0, 4.0, 1.0,
        pr["fx"], pr["fy"], pr["cx"], pr["cy"], pr["bf"],
        use_huber=use_huber)


def _ba_case(case):
    pr = build_problem(np.random.default_rng(0), obs_noise=0.3)
    if case == "bad joint":
        pr["jo_obs"][0, 2, 4, :2] += 30.0
    if case == "broken motion":
        pr["jo_obs"][0, 3, 1, :] += np.array([40.0, 25.0, 40.0])
    return pr, case != "huber off"


@pytest.mark.parametrize("case", ["clean", "broken motion", "bad joint",
                                  "huber off"])
def test_human_bundle_adjust_matches_jax(case):
    pr, use_huber = _ba_case(case)
    ref = jax.device_get(run_ba(pr, pr["joints0"], pr["seg0"],
                                use_huber=use_huber))
    out = _run_port(pr, use_huber)
    for f in ("static_inlier", "key_inlier", "rigid_inlier",
              "motion_inlier"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert np.abs(out.cam_t.numpy() - ref.cam_t).max() < 1e-5
    assert np.abs(out.cam_R.numpy() - ref.cam_R).max() < 1e-5
    assert np.abs(out.points.numpy() - ref.points).max() < 1e-4
    assert np.abs(out.mot_t.numpy() - ref.mot_t).max() < 2e-4
    assert np.abs(out.seg_len.numpy() - ref.seg_len).max() < 2e-3
    gap = np.linalg.norm(out.joints.numpy() - ref.joints, axis=-1)
    assert gap.max() < 1e-2 and np.median(gap) < 1e-4, (gap.max(),
                                                        np.median(gap))
    if case == "broken motion":
        mi = out.motion_inlier.numpy()
        assert not mi[0, 2, 0] or not mi[0, 3, 0]


def test_human_bundle_adjust_sums_four_blocks_a_step(monkeypatch):
    """60 segment sums a solve: 15 steps x (the static edges' Hcc | bc,
    Hpp | bp and Wagg, then the human families' one column)."""
    widths = []

    def counted(vals, seg):
        widths.append(vals.shape[1])
        return segment_sum(vals, seg)

    import airdos_tpu_torch.solvers.local_ba as lba
    monkeypatch.setattr(lba, "segment_sum", counted)
    monkeypatch.setattr(thba, "segment_sum", counted)
    _run_port(_ba_case("clean")[0])
    assert widths == [42, 12, 18, 1] * 15


def _scatter_inputs():
    """The human families' keys of 2 trajectories x 4 poses seen from 3
    cameras, one pose missing and one unobserved, with random entries."""
    T, L, C = 2, 4, 3
    exists = np.ones((T, L, N_PARTS), bool)
    exists[1, 3] = False
    jo_cam = np.array([[0, 1, 2, 0], [1, -1, 2, 0]], np.int32)
    ed = thba.human_edges(_t(jo_cam), torch.zeros((T, L, N_PARTS, 3)),
                          _t(exists), _t(exists), _t(exists),
                          torch.ones(T, dtype=torch.bool),
                          torch.full((T, L), 0.5),
                          torch.ones((T, L, 5), dtype=torch.bool), C)
    D = 6 * C + 3 * T * L * N_PARTS + 20 * T
    keys, keep = thba.scatter_keys(
        ed.gidx, (ed.hp_valid, ed.rg_valid, ed.mo_valid), D)
    rng = np.random.default_rng(3)
    vals = (rng.normal(0, 1, (len(keys), 1)) *
            10.0 ** rng.uniform(-3, 3, (len(keys), 1))).astype(np.float32)
    return keys, keep, torch.from_numpy(vals), D


def test_compact_scatter_matches_jax_scatter_add_on_duplicates():
    keys, keep, vals, D = _scatter_inputs()
    seg, pos = make_compact_segments(keys, keep)
    # positions repeat: a joint's diagonal block collects its projection,
    # rigidity and motion edges
    assert seg.n < int(keep.sum())
    assert int(seg.offsets.diff().max()) >= 5
    got = torch.zeros(D * D + D)
    got[pos] = segment_sum(vals, seg)[:, 0]
    kept = keep.numpy()
    want = np.asarray(jnp.zeros(D * D + D, jnp.float32)
                      .at[keys.numpy()[kept]].add(vals.numpy()[kept, 0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    # bit-equal run to run, and to the plain version it calls
    again = torch.zeros(D * D + D)
    again[pos] = segment_sum(vals, seg)[:, 0]
    assert torch.equal(got, again)
    assert torch.equal(segment_sum_ref(vals, seg.key, seg.n)[:, 0],
                       got[pos])
    # rows outside keep join no segment
    assert int(seg.offsets[-1]) == int(keep.sum())


# ------------------------------------------------------------- drivers
def _hand_built_maps():
    """tests/test_human_ba.py's hand-built map (two keyframes, 60 points,
    one walking human over five poses) in airdos_tpu, and its copy in the
    port."""
    rng = np.random.default_rng(7)
    cfg = jcfg.SlamConfig()
    cfg.camera = small_camera()
    cfg.device.max_local_points = 256
    cfg.device.max_ba_edges = 1024
    cfg.device.max_trajectories = 2
    cfg.device.max_trajectory_len = 8
    cam = cfg.camera
    fx, fy, cx, cy, bf = cam.fx, cam.fy, cam.cx, cam.cy, cam.bf
    P = 60
    pts = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P),
                    rng.uniform(4, 12, P)], axis=1).astype(np.float32)

    def make_kf(m, kf_id, tcw, t):
        xc = pts + tcw[None, :]
        z = xc[:, 2]
        u = fx * xc[:, 0] / z + cx
        v = fy * xc[:, 1] / z + cy
        f = types.SimpleNamespace(
            index=kf_id, timestamp=t, Rcw=np.eye(3, dtype=np.float32),
            tcw=np.asarray(tcw, np.float32),
            xy=np.stack([u, v], 1).astype(np.float32),
            xy_un=np.stack([u, v], 1).astype(np.float32),
            octave=np.zeros(P, np.int32), angle=np.zeros(P, np.float32),
            response=np.ones(P, np.float32),
            desc32=rng.integers(0, 2 ** 32, (P, 8), dtype=np.uint32),
            u_right=(u - bf / z).astype(np.float32),
            depth=z.astype(np.float32), valid=np.ones(P, bool),
            mp_idx=np.full(P, -1, np.int32))
        kf = JaxKeyFrame(kf_id, f)
        m.add_keyframe(kf)
        return kf

    m = JaxMap()
    kf0 = make_kf(m, 0, np.zeros(3, np.float32), 0.0)
    kf1 = make_kf(m, 1, np.array([0.1, 0.0, -0.2], np.float32), 0.5)
    pids = m.create_points(kf0, np.arange(P), pts)
    for fid in range(P):
        m.add_observation(int(pids[fid]), kf1, fid)
    kf0.ordered_covis, kf1.ordered_covis = [1], [0]
    kf0.covis, kf1.covis = {1: P}, {0: P}
    base = np.array([0.5, 0.0, 6.0], np.float32)
    vel = np.array([0.3, 0.0, 0.0], np.float32)
    traj = JaxHumanTrajectory(track_id=0)
    for i in range(5):
        t = 0.25 * i
        j = np.zeros((18, 3), np.float32)
        j[:14] = SKEL + base + vel * t
        kf = kf0 if t < 0.5 else kf1
        xc = j[:14] + kf.tcw[None, :]
        z = xc[:, 2]
        u = fx * xc[:, 0] / z + cx
        v = fy * xc[:, 1] / z + cy
        obs = np.full((18, 4), -1.0, np.float32)
        obs[:14, 0] = u + rng.normal(0, 0.3, 14)
        obs[:14, 1] = v + rng.normal(0, 0.3, 14)
        obs[:14, 2] = u - bf / z + rng.normal(0, 0.3, 14)
        jw = j.copy()
        jw[:14] += rng.normal(0, 0.03, (14, 3)).astype(np.float32)
        traj.add_pose(JaxHumanPose(
            track_id=0, timestamp=t, kf_id=kf.id, joints_w=jw,
            bad=np.zeros(18, bool), lost=np.zeros(18, bool),
            optimized=np.zeros(18, bool), obs_uvd=obs,
            in_keyframe=i != 1))       # pose 1: a frame between keyframes
    m.trajectories[0] = traj
    return cfg, m, map_from(m)


class _Ext:
    sigma2 = np.asarray([1.2 ** (2 * i) for i in range(8)], np.float32)


def assert_same_trajectories(jm, tm, joint_tol=5e-3, other_tol=0.25,
                             flag_share=1.0):
    """The same poses; joints with a projection edge (a keyframe pose, not
    bad) within joint_tol, the others within other_tol; the outlier flags
    (segment bad / optimized, joint bad / lost) equal on at least
    flag_share of their entries, the limb lengths of the segments flagged
    alike within 2e-3 m."""
    assert sorted(tm.trajectories) == sorted(jm.trajectories)
    assert tm.optimized_track_ids == jm.optimized_track_ids
    flags = []
    for tid, jt in jm.trajectories.items():
        tt = tm.trajectories[tid]
        assert len(tt) == len(jt) and tt.optimized == jt.optimized
        assert abs(tt.bad_count - jt.bad_count) <= (1 - flag_share) * 10 * \
            len(jt)
        same = (tt.segment_bad == jt.segment_bad) & \
            (tt.segment_optimized == jt.segment_optimized)
        flags.append(same)
        assert np.abs(tt.segment_len - jt.segment_len)[same].max() < 2e-3
        assert np.abs(tt.motion_t - jt.motion_t).max() < 1e-3
        for a, b in zip(tt.poses, jt.poses):
            assert (a.kf_id, a.in_keyframe, a.timestamp) == \
                (b.kf_id, b.in_keyframe, b.timestamp)
            np.testing.assert_array_equal(a.optimized, b.optimized)
            flags += [a.bad == b.bad, a.lost == b.lost]
            gap = np.linalg.norm(a.joints_w - b.joints_w, axis=1)
            seen = ~a.bad & ~b.bad & b.in_keyframe
            assert gap[seen].max(initial=0.0) <= joint_tol, gap
            assert gap.max() <= other_tol, gap
    assert np.concatenate(flags).mean() >= flag_share


def test_human_local_ba_driver_matches_jax():
    cfg, jm, tm = _hand_built_maps()
    jbd.HumanLocalBA(cfg, jm, _Ext())(jm, 1)
    drv = tbd.HumanLocalBA(config_from(cfg), tm, _Ext(), device="cpu")
    drv(tm, 1)
    assert drv.n_runs == 1 and jm.trajectories[0].optimized
    assert_same_trajectories(jm, tm)
    for kid, jk in jm.kfs.items():
        assert np.abs(tm.kfs[kid].tcw - jk.tcw).max() < 1e-5
        assert np.abs(tm.kfs[kid].Rcw - jk.Rcw).max() < 1e-5
    n = jm.points.n
    assert tm.points.obs[:n] == jm.points.obs[:n]
    assert np.abs(tm.points.pos[:n] - jm.points.pos[:n]).max() < 1e-4


@pytest.mark.parametrize("fast", [False, True])
def test_human_local_ba_pose_windows_match_jax(fast):
    """The windowed variant takes the poses whose reference keyframe is in
    the window; use_fast_human_ba the whole trajectory (Optimizer.cc:736-
    1493).  Keyframe 0 is culled from the window here, so the two differ."""
    cfg, jm, _ = _hand_built_maps()
    cfg.optimizer.use_fast_human_ba = fast
    jm.trajectories[0].poses[0].kf_id = 5        # a keyframe not in the map
    tm = map_from(jm)
    jp = jbd.HumanLocalBA(cfg, jm, _Ext())._assemble(1)
    tp = tbd.HumanLocalBA(config_from(cfg), tm, _Ext(),
                          device="cpu")._assemble(1)
    assert tp["pose_windows"] == jp["pose_windows"]
    assert len(tp["pose_windows"][0]) == (5 if fast else 4)
    for a, b in zip(tp["arrays"], jp["arrays"]):
        np.testing.assert_array_equal(a, b)


def test_select_window_trajectories_matches_jax():
    def mk(mod_pose, mod_traj, tid, kf_ids):
        tr = mod_traj(tid)
        for k in kf_ids:
            tr.add_pose(mod_pose(
                track_id=tid, timestamp=float(k), kf_id=k,
                joints_w=np.zeros((18, 3), np.float32),
                bad=np.zeros(18, bool), lost=np.zeros(18, bool),
                optimized=np.zeros(18, bool)))
        return tr

    from airdos_tpu_torch.slam.map import HumanPose, HumanTrajectory
    spec = {tid: [0, 1, 2, 3, 4, 5] for tid in range(6)}
    spec.update({tid: [10, 11, 12, 13, 14] for tid in range(100, 103)})
    spec[999] = [14]
    jt = {t: mk(JaxHumanPose, JaxHumanTrajectory, t, k)
          for t, k in spec.items()}
    tt = {t: mk(HumanPose, HumanTrajectory, t, k) for t, k in spec.items()}
    for window, cap in ((set(range(3, 15)), 4), ({4, 5}, 8), (set(), 8)):
        want = [t.track_id for t in
                jbd.select_window_trajectories(jt, window, cap)]
        got = [t.track_id for t in
               tbd.select_window_trajectories(tt, window, cap)]
        assert got == want


def test_map_from_carries_trajectories():
    _, jm, _ = _hand_built_maps()
    jm.optimized_track_ids.add(0)
    jm.current_track_ids = [0]
    tm = map_from(jm)
    assert_same_trajectories(jm, tm, joint_tol=0.0, other_tol=0.0)
    np.testing.assert_array_equal(tm.trajectories[0].poses[2].obs_uvd,
                                  jm.trajectories[0].poses[2].obs_uvd)
    # by value: the copy moves alone
    tm.trajectories[0].poses[0].joints_w[0, 0] += 1.0
    tm.trajectories[0].segment_len[0] += 1.0
    assert jm.trajectories[0].poses[0].joints_w[0, 0] != \
        tm.trajectories[0].poses[0].joints_w[0, 0]
    assert jm.trajectories[0].segment_len[0] != \
        tm.trajectories[0].segment_len[0]
    assert tm.current_track_ids == [0]


# ------------------------------------------------------------- readers
def test_text_readers_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    pose = rng.uniform(0, 640, (3, 54))
    (tmp_path / "ap.txt").write_text(
        "\n".join(" ".join(f"{v:.4f}" for v in row) for row in pose))
    (tmp_path / "ids.txt").write_text("7\n-1\n3\n")
    (tmp_path / "gt.txt").write_text(
        "\n".join(" ".join(f"{v:.6f}" for v in row)
                  for row in rng.normal(0, 1, (4, 8))))
    (tmp_path / "empty.txt").write_text("")
    for name, fn in (("ap.txt", "read_alphapose_file"),
                     ("ids.txt", "read_track_ids"),
                     ("gt.txt", "read_ground_truth_poses"),
                     ("empty.txt", "read_alphapose_file"),
                     ("missing.txt", "read_track_ids")):
        want = getattr(jds, fn)(tmp_path / name)
        got = getattr(tds, fn)(tmp_path / name)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tds.read_alphapose_file(tmp_path / "ap.txt").shape == (3, 18, 3)
