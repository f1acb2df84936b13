"""The port's multi-device path on an 8-rank CPU mesh, against the port's
single-device solvers and airdos_tpu's sharded solvers on make_mesh(8)
(tests/test_sharded_ba.py's problems and tolerances; conftest forces
JAX's 8-device CPU platform).  Stated tolerances:

- each port sharded path against the port's single-device solver:
  tests/test_sharded_ba.py's (local BA: R 2e-4, t 2e-3 m, median point
  error within 0.01 m of the single solve's, inlier agreement > 0.98;
  global BA: t 2e-3 m; human BA: cameras 2e-4 / 2e-3 m, limb lengths and
  motions 5e-3, key inliers equal, static inlier agreement > 0.98).  The
  shards sum their rows in another order than one table does, so bit
  equality is not expected.
- against airdos_tpu's sharded solvers: the local BA at the port's local
  BA limits (R 1e-4, t 1e-4 m, the same edge inliers, points seen by two
  or more inlier edges within 1e-3 m); the global BA poses within 1e-4
  and points within 1e-3 m; the human BA's joints with an inlier
  projection edge within 1.5e-3 m, cameras within 1e-4 m and the same
  key inliers; EPnP and Sim3: the same winner and inliers, pose within
  1e-4.
- EPnP and Sim3 sharded against single-device on the same samples: the
  same winner and inliers, poses bit-equal (each rank scores its
  hypotheses as the whole batch does, and the first best wins in both).
- two sharded runs: bit-equal (psum adds on rank 0 in rank order).
- System with Device.NChips = 8 (every static BA solve sharded):
  ATE < 0.1 m, and against the NChips = 1 run the same keyframes and
  poses within 5 mm; a map reloaded into an 8-rank System relocalizes
  through the sharded EPnP on the same frame as a 1-rank System, within
  1e-4 m.
"""
import sys
import threading
from collections import namedtuple
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airdos_tpu.parallel import sharded_ba as jsb
from airdos_tpu.solvers.human_ba import N_PARTS
from airdos_tpu_torch import graft_entry
from airdos_tpu_torch.config import SlamConfig
from airdos_tpu_torch.geometry.se3 import se3_exp, so3_exp
from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld, small_camera
from airdos_tpu_torch.io.tum import ate_rmse
from airdos_tpu_torch.parallel import mesh as tmesh
from airdos_tpu_torch.parallel import sharded_ba as tsb
from airdos_tpu_torch.slam.ba_driver import HumanLocalBA
from airdos_tpu_torch.slam.map import SlamMap
from airdos_tpu_torch.slam.system import System
from airdos_tpu_torch.solvers.epnp import epnp_ransac
from airdos_tpu_torch.solvers.global_ba import global_bundle_adjust
from airdos_tpu_torch.solvers.human_ba import human_bundle_adjust
from airdos_tpu_torch.solvers.local_ba import local_bundle_adjust
from airdos_tpu_torch.solvers.sim3 import sim3_ransac

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_human_ba import build_problem  # noqa: E402
from test_local_ba import make_problem  # noqa: E402
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)

N_DEV = 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------------ the mesh
def test_psum_is_the_rank_ordered_sum_bit_for_bit():
    """Summands of mixed magnitudes, whose float32 sum depends on the
    order: psum gives x_0 + x_1 + ... + x_7 exactly, on every rank."""
    rng = np.random.default_rng(5)
    xs = [_t((rng.standard_normal(64) * 10.0 ** rng.integers(-6, 6, 64))
             .astype(np.float32)) for _ in range(N_DEV)]
    want = xs[0]
    for x in xs[1:]:
        want = want + x
    mesh = tmesh.make_mesh(N_DEV, "cpu")
    got = [None] * N_DEV

    def fn(group, x):
        got[group.rank] = group.psum(x[0])
        return got[group.rank]

    mesh.run(fn, (), (torch.stack(xs),))
    assert all(torch.equal(g, want) for g in got)
    assert not torch.equal(sum(reversed(xs)), want)   # the order matters


def test_all_gather_and_sharded_outputs_keep_rank_order():
    mesh = tmesh.make_mesh(N_DEV, "cpu")
    Out = namedtuple("Out", "gathered rows")

    def fn(group, rows):
        return Out(gathered=group.all_gather(rows[:, 0] * 0 + group.rank),
                   rows=rows + 1)

    x = torch.arange(4 * N_DEV, dtype=torch.float32)[:, None]
    out = mesh.run(fn, (), (x,), sharded_out=("rows",))
    assert torch.equal(out.gathered,
                       torch.arange(N_DEV, dtype=torch.float32)[:, None]
                       .expand(N_DEV, 4))
    assert torch.equal(out.rows, x + 1)
    with pytest.raises(ValueError, match="multiple"):
        mesh.run(fn, (), (x[:-1],))


def test_a_raising_rank_surfaces_its_own_exception():
    """Rank 3 raises before the first psum while the others wait in it:
    its exception comes out of run, not the others' MeshAborted, and no
    rank hangs (the call is bounded by a 20 s join)."""
    mesh = tmesh.make_mesh(N_DEV, "cpu")

    def fn(group, x):
        if group.rank == 3:
            raise KeyError("rank 3")
        return group.psum(group.psum(x))

    caught = []

    def call():
        try:
            mesh.run(fn, (), (torch.ones(N_DEV),))
        except Exception as e:          # noqa: BLE001 (inspected below)
            caught.append(e)

    th = threading.Thread(target=call, daemon=True)
    th.start()
    th.join(timeout=20)
    assert not th.is_alive()
    assert len(caught) == 1 and isinstance(caught[0], KeyError), caught


def test_make_mesh_never_falls_back(monkeypatch):
    """No card: a CUDA mesh raises.  One visible card: four ranks raise
    unless AIRDOS_TORCH_VIRTUAL_DEVICES asks for virtual ranks, which then
    all sit on that card.  The CPU's ranks are always virtual."""
    monkeypatch.delenv(tmesh.VIRTUAL_DEVICES_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(4, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="only 1 devices"):
        tmesh.make_mesh(4, "cuda:0")
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "4")
    m = tmesh.make_mesh(4, "cuda:0")
    assert m.virtual and m.devices == (torch.device("cuda:0"),) * 4
    with pytest.raises(RuntimeError, match="only 4 devices"):
        tmesh.make_mesh(8, "cuda:0")
    cpu = tmesh.make_mesh(N_DEV, "cpu")
    assert cpu.virtual and cpu.size == N_DEV
    assert "8 virtual ranks on cpu" in repr(cpu)


# --------------------------------------------------------- local + GBA
def _local_problem(rng):
    fx, fy, cx, cy, bf, pts_gt, cams, e_cam, e_pt, e_obs = make_problem(
        rng, C=4, P=48)
    C, E = len(cams), len(e_cam)
    cam_R = np.stack([c[0] for c in cams])
    cam_t = np.stack([c[1] for c in cams])
    fixed = np.zeros(C, bool)
    fixed[:2] = True
    cam_R_n, cam_t_n = cam_R.copy(), cam_t.copy()
    for c in range(2, C):
        dR, dt = se3_exp(_t(np.concatenate(
            [rng.normal(0, 0.03, 3), rng.normal(0, 0.01, 3)])
            .astype(np.float32)))
        cam_R_n[c] = dR.numpy() @ cam_R[c]
        cam_t_n[c] = dR.numpy() @ cam_t[c] + dt.numpy()
    pts_n = pts_gt + rng.normal(0, 0.05, pts_gt.shape).astype(np.float32)
    pad = -E % N_DEV
    arrays = (cam_R_n, cam_t_n, fixed, pts_n, np.ones(len(pts_gt), bool),
              np.concatenate([e_cam, np.zeros(pad, np.int32)]),
              np.concatenate([e_pt, np.zeros(pad, np.int32)]),
              np.concatenate([e_obs, np.zeros((pad, 3), np.float32)]),
              np.concatenate([np.ones(E, np.float32),
                              np.zeros(pad, np.float32)]),
              np.concatenate([np.ones(E, bool), np.zeros(pad, bool)]))
    return arrays, (fx, fy, cx, cy, bf), pts_gt


def test_sharded_local_and_global_ba(rng):
    arrays, intr, pts_gt = _local_problem(rng)
    targs = tuple(_t(a) for a in arrays)
    jargs = tuple(jnp.asarray(a) for a in arrays)
    mesh = tsb.make_mesh(N_DEV, "cpu")

    single = local_bundle_adjust(*targs, *intr, iters1=4, iters2=6)
    run = tsb.sharded_local_bundle_adjust(mesh, iters1=4, iters2=6)
    sharded = run(*targs, *intr)
    assert _equal(sharded, run(*targs, *intr))
    np.testing.assert_allclose(sharded.R, single.R, atol=2e-4)
    np.testing.assert_allclose(sharded.t, single.t, atol=2e-3)
    perr_s = np.linalg.norm(sharded.points.numpy() - pts_gt, axis=1)
    perr_1 = np.linalg.norm(single.points.numpy() - pts_gt, axis=1)
    assert np.median(perr_s) < 0.05
    assert abs(np.median(perr_s) - np.median(perr_1)) < 0.01
    assert (sharded.edge_inlier == single.edge_inlier).float().mean() > 0.98

    jmesh = jsb.make_mesh(N_DEV)
    ref = jax.device_get(jsb.sharded_local_bundle_adjust(
        jmesh, iters1=4, iters2=6)(*jargs, *intr))
    assert np.abs(sharded.R.numpy() - ref.R).max() < 1e-4
    assert np.abs(sharded.t.numpy() - ref.t).max() < 1e-4
    np.testing.assert_array_equal(sharded.edge_inlier.numpy(),
                                  ref.edge_inlier)
    n_in = np.bincount(arrays[6][ref.edge_inlier], minlength=len(pts_gt))
    gap = np.linalg.norm(sharded.points.numpy() - ref.points, axis=1)
    assert gap[n_in >= 2].max() < 1e-3

    g1 = global_bundle_adjust(*targs, *intr, iters1=3, iters2=4, cg_iters=32)
    grun = tsb.sharded_global_bundle_adjust(mesh, iters1=3, iters2=4,
                                            cg_iters=32)
    gs = grun(*targs, *intr)
    assert _equal(gs, grun(*targs, *intr))
    np.testing.assert_allclose(gs.t, g1.t, atol=2e-3)
    assert np.median(np.linalg.norm(gs.points.numpy() - pts_gt, axis=1)) \
        < 0.05
    gref = jax.device_get(jsb.sharded_global_bundle_adjust(
        jmesh, iters1=3, iters2=4, cg_iters=32)(*jargs, *intr))
    assert np.abs(gs.R.numpy() - gref.R).max() < 1e-4
    assert np.abs(gs.t.numpy() - gref.t).max() < 1e-4
    assert np.abs(gs.points.numpy() - gref.points).max() < 1e-3


def test_sharded_pose_step_matches_jax(rng):
    fx = fy = 320.0
    cx, cy, bf = 160.0, 120.0, 80.0
    E = 64 * N_DEV
    xw = rng.uniform([-2, -2, 3], [2, 2, 12], (E, 3)).astype(np.float32)
    u = fx * xw[:, 0] / xw[:, 2] + cx
    v = fy * xw[:, 1] / xw[:, 2] + cy
    obs = np.stack([u, v, u - bf / xw[:, 2]], axis=1).astype(np.float32)
    obs += rng.normal(0, 0.5, obs.shape).astype(np.float32)
    t0 = np.array([0.05, -0.02, 0.1], np.float32)
    w = np.ones(E, np.float32)
    args = (torch.eye(3), _t(t0), _t(xw), _t(obs), _t(w), fx, fy, cx, cy,
            bf)
    R, t = tsb.sharded_pose_optimize_step(tsb.make_mesh(N_DEV, "cpu"))(*args)
    R1, t1 = tsb.sharded_pose_optimize_step(tsb.make_mesh(1, "cpu"))(*args)
    assert (R - R1).abs().max() < 1e-5 and (t - t1).abs().max() < 1e-5
    Rj, tj = jax.device_get(jsb.sharded_pose_optimize_step(
        jsb.make_mesh(N_DEV))(jnp.eye(3), jnp.asarray(t0), jnp.asarray(xw),
                              jnp.asarray(obs), jnp.asarray(w),
                              fx, fy, cx, cy, bf))
    assert np.abs(R.numpy() - Rj).max() < 1e-5
    assert np.abs(t.numpy() - tj).max() < 1e-5
    assert np.linalg.norm(t.numpy()) < 0.5 * np.linalg.norm(t0)


# ------------------------------------------------------------ human BA
def _human_args(pr, pts0, E=None):
    """human_bundle_adjust's arguments for build_problem's problem with
    the static edge table padded to E rows (invalid padding)."""
    T, L, P, Es = pr["T"], pr["L"], pr["P"], pr["Es"]
    E = Es if E is None else E
    es_cam = np.zeros(E, np.int32)
    es_pt = np.zeros(E, np.int32)
    es_obs = np.full((E, 3), -1.0, np.float32)
    es_valid = np.zeros(E, bool)
    es_cam[:Es], es_pt[:Es], es_obs[:Es] = pr["es_cam"], pr["es_pt"], \
        pr["es_obs"]
    es_valid[:Es] = True
    ones = np.ones((T, L, N_PARTS), bool)
    arrays = (pr["cam_R"], pr["cam_t"], pr["cam_fixed"], pts0,
              np.ones(P, bool), es_cam, es_pt, es_obs, np.ones(E, np.float32),
              es_valid, pr["joints0"], ones, pr["jo_cam"], pr["jo_obs"], ones,
              pr["seg0"], np.ones((T, N_PARTS), bool), ones,
              np.tile(np.eye(3, dtype=np.float32), (T, 1, 1)),
              np.zeros((T, 3), np.float32), np.ones(T, bool), pr["pose_dt"],
              np.ones((T, L, 5), bool))
    scalars = (1.0, 0.5, 20.0, 20.0, 1.0, 4.0, 1.0,
               pr["fx"], pr["fy"], pr["cx"], pr["cy"], pr["bf"])
    return arrays, scalars


def test_sharded_human_ba(rng):
    pr = build_problem(rng, obs_noise=0.2)
    assert pr["Es"] % N_DEV == 0, pr["Es"]
    pts0 = pr["pts_gt"] + rng.normal(0, 0.05, (pr["P"], 3)) \
        .astype(np.float32)
    arrays, scalars = _human_args(pr, pts0)
    targs = tuple(_t(a) for a in arrays) + scalars
    single = human_bundle_adjust(*targs, iters1=4, iters2=6)
    run = tsb.sharded_human_bundle_adjust(tsb.make_mesh(N_DEV, "cpu"),
                                          iters1=4, iters2=6)
    sharded = run(*targs)
    assert _equal(sharded, run(*targs))
    np.testing.assert_allclose(sharded.cam_t, single.cam_t, atol=2e-3)
    np.testing.assert_allclose(sharded.cam_R, single.cam_R, atol=2e-4)
    jerr_s = np.linalg.norm(sharded.joints.numpy() - pr["joints_gt"], axis=-1)
    jerr_1 = np.linalg.norm(single.joints.numpy() - pr["joints_gt"], axis=-1)
    assert np.median(jerr_s) < 0.12
    assert abs(np.median(jerr_s) - np.median(jerr_1)) < 0.01
    np.testing.assert_allclose(sharded.seg_len, single.seg_len, atol=5e-3)
    np.testing.assert_allclose(sharded.mot_t, single.mot_t, atol=5e-3)
    assert (sharded.static_inlier == single.static_inlier).float().mean() \
        > 0.98
    assert torch.equal(sharded.key_inlier, single.key_inlier)

    ref = jax.device_get(jsb.sharded_human_bundle_adjust(
        jsb.make_mesh(N_DEV), iters1=4, iters2=6)(
            *(jnp.asarray(a) for a in arrays), *scalars))
    np.testing.assert_array_equal(sharded.key_inlier.numpy(), ref.key_inlier)
    assert np.abs(sharded.cam_t.numpy() - ref.cam_t).max() < 1e-4
    gap = np.linalg.norm(sharded.joints.numpy() - ref.joints, axis=-1)
    assert gap[ref.key_inlier].max() < 1.5e-3, gap[ref.key_inlier].max()


def test_human_ba_driver_pads_edges_to_mesh_multiple(rng):
    """HumanLocalBA with an edge budget that is not a multiple of the mesh
    pads it up and installs the sharded solver (one call, no chunks);
    the padded sharded solve agrees with the single-device solve on the
    unpadded problem (padding rows are es_valid=False)."""

    class _Ext:
        sigma2 = np.asarray([1.2 ** (2 * i) for i in range(4)], np.float32)

    cfg = SlamConfig()
    cfg.camera = small_camera()
    cfg.device.n_chips = N_DEV
    cfg.device.max_ba_edges = 1001
    cfg.system.is_offline = False
    drv = HumanLocalBA(cfg, SlamMap(), _Ext(), device="cpu")
    assert drv.E % N_DEV == 0 and drv.E >= 1001
    assert drv.mesh.size == N_DEV and not drv._chunked
    assert "sharded" in drv._sharded.__qualname__

    pr = build_problem(rng, obs_noise=0.2)
    Es = pr["Es"]
    pts0 = pr["pts_gt"] + rng.normal(0, 0.05, (pr["P"], 3)) \
        .astype(np.float32)
    arrays, scalars = _human_args(pr, pts0)
    single = human_bundle_adjust(*(_t(a) for a in arrays), *scalars,
                                 iters1=4, iters2=6)
    padded, _ = _human_args(pr, pts0, Es + (-Es) % N_DEV + N_DEV)
    sharded = tsb.sharded_human_bundle_adjust(drv.mesh, iters1=4, iters2=6)(
        *(_t(a) for a in padded), *scalars)
    np.testing.assert_allclose(sharded.cam_t, single.cam_t, atol=2e-3)
    np.testing.assert_allclose(sharded.joints, single.joints, atol=5e-3)
    np.testing.assert_allclose(sharded.seg_len, single.seg_len, atol=5e-3)


# ------------------------------------------------------------ RANSACs
def test_sharded_sim3_ransac(rng):
    fx = fy = 400.0
    cx, cy = 160.0, 120.0
    n = 50
    x2 = rng.uniform([-3, -2, 4], [3, 2, 15], (n, 3)).astype(np.float32)
    R_gt = so3_exp(torch.tensor([0.05, 0.3, -0.1])).numpy()
    t_gt = np.array([0.5, -0.2, 0.8], np.float32)
    x1 = ((R_gt @ x2.T).T + t_gt).astype(np.float32)
    x1 += rng.normal(0, 0.01, x1.shape).astype(np.float32)
    out = rng.choice(n, 10, replace=False)
    x1[out] += rng.uniform(1, 3, (10, 3)).astype(np.float32)
    samples = rng.integers(0, n, (128, 3)).astype(np.int32)
    err = np.full(n, 9.21 * 4, np.float32)
    args = (x1, x2, np.ones(n, bool), samples, err, err)
    single = sim3_ransac(*(_t(a) for a in args), fx, fy, cx, cy)
    sharded = tsb.sharded_sim3_ransac(tsb.make_mesh(N_DEV, "cpu"))(
        *(_t(a) for a in args), fx, fy, cx, cy)
    assert int(single.n_inliers) >= 35
    assert _equal(sharded, single)
    ref = jax.device_get(jsb.sharded_sim3_ransac(jsb.make_mesh(N_DEV))(
        *(jnp.asarray(a) for a in args), fx, fy, cx, cy))
    np.testing.assert_array_equal(sharded.inliers.numpy(), ref.inliers)
    assert np.abs(sharded.R.numpy() - ref.R).max() < 1e-4
    assert np.abs(sharded.t.numpy() - ref.t).max() < 1e-4


def test_sharded_pnp_ransac(rng):
    fx = fy = 320.0
    cx, cy = 160.0, 120.0
    n = 80
    pw = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                   rng.uniform(4, 15, n)], axis=1).astype(np.float32)
    R_gt = so3_exp(torch.tensor([0.05, -0.1, 0.03])).numpy()
    t_gt = np.asarray([0.2, -0.1, 0.4], np.float32)
    xc = pw @ R_gt.T + t_gt
    uv = np.stack([fx * xc[:, 0] / xc[:, 2] + cx,
                   fy * xc[:, 1] / xc[:, 2] + cy], axis=1).astype(np.float32)
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    out = rng.permutation(n)[: n // 4]
    uv[out] += rng.uniform(20, 60, (len(out), 2)).astype(np.float32)
    samples = rng.integers(0, n, (256, 4)).astype(np.int32)
    args = (pw, uv, np.ones(n, bool), np.full(n, 5.991, np.float32), samples)
    single = epnp_ransac(*(_t(a) for a in args), fx, fy, cx, cy)
    sharded = tsb.sharded_epnp_ransac(tsb.make_mesh(N_DEV, "cpu"))(
        *(_t(a) for a in args), fx, fy, cx, cy)
    assert int(single.n_inliers) > 0.6 * n
    assert _equal(sharded, single)
    ref = jax.device_get(jsb.sharded_epnp_ransac(jsb.make_mesh(N_DEV))(
        *(jnp.asarray(a) for a in args), fx, fy, cx, cy))
    np.testing.assert_array_equal(sharded.inliers.numpy(), ref.inliers)
    assert np.abs(sharded.R.numpy() - ref.R).max() < 1e-4
    assert np.abs(sharded.t.numpy() - ref.t).max() < 1e-4


# ------------------------------------------------------------ System
def _system_cfg(n_chips):
    cfg = SlamConfig()
    cfg.camera = small_camera()
    cfg.orb.n_features = 600
    cfg.orb.n_levels = 4
    cfg.human.ok = False
    cfg.system.is_offline = True
    cfg.device.max_keypoints = 1024
    cfg.device.max_local_kfs = 8
    cfg.device.max_fixed_kfs = 4
    cfg.device.max_local_points = 1024
    cfg.device.max_ba_edges = 4096
    cfg.device.n_chips = n_chips
    return cfg


def test_system_runs_with_sharded_ba_drivers(monkeypatch, tmp_path):
    """System with Device.NChips = 8 drives the sharded local BA at every
    solve, end to end, and a reloaded map relocalizes through the sharded
    EPnP RANSAC."""
    runs = []
    plain_run = tmesh.Mesh.run

    def counted(self, fn, *a, **k):
        runs.append(fn.__qualname__)
        return plain_run(self, fn, *a, **k)

    monkeypatch.setattr(tmesh.Mesh, "run", counted)
    world = SyntheticStereoWorld(seed=0, n_points=200, cam=small_camera())
    seq = list(world.sequence(9, dt=0.1, yaw_rate=0.008))
    out = {}
    for n in (N_DEV, 1):
        runs.clear()
        slam = System(_system_cfg(n), device="cpu")
        for data, _, _ in seq[:8]:
            slam.track_stereo(data)
        assert slam.tracking.state.name == "OK"
        _, _, twc_e = slam.tracking.trajectory_tum()
        out[n] = dict(kfs=sorted(slam.map.kfs), t=twc_e,
                      solves=slam.static_ba.n_solves, runs=list(runs))
        if n == 1:
            slam.save_map(tmp_path / "map.npz")
        slam.shutdown()
    sharded, single = out[N_DEV], out[1]
    assert len(sharded["kfs"]) >= 2 and sharded["solves"] >= 1
    assert sharded["runs"] == \
        ["sharded_local_bundle_adjust.<locals>.run.<locals>.shard_fn"] * \
        sharded["solves"]
    assert single["runs"] == []
    gt = np.asarray([twc for _, _, twc in seq[:8]])
    assert ate_rmse(sharded["t"], gt[:len(sharded["t"])]) < 0.1
    assert sharded["kfs"] == single["kfs"]
    assert np.abs(sharded["t"] - single["t"]).max() < 5e-3

    centres = {}
    for n in (N_DEV, 1):
        slam = System(_system_cfg(n), device="cpu")
        slam.load_map(tmp_path / "map.npz")
        slam.track_stereo(seq[8][0])
        assert slam.tracking.state.name == "OK"
        assert slam.tracking.last_reloc_frame == seq[8][0].index
        assert (slam.tracking._sharded_pnp is not None) == (n > 1)
        centres[n] = slam.tracking.last_frame.Ow
        slam.shutdown()
    assert np.abs(centres[N_DEV] - centres[1]).max() < 1e-4


# ------------------------------------------------------------ entry
def test_dryrun_multichip_on_cpu_ranks():
    graft_entry.dryrun_multichip(4, device="cpu")


def test_entry_runs_the_front_end_and_a_pose_step():
    fn, args = graft_entry.entry(device="cpu")
    xy, desc, depth, R, t, n_inl = fn(*args)
    assert xy.shape[1] == 2 and desc.shape == (xy.shape[0], 8)
    assert torch.isfinite(R).all() and torch.isfinite(t).all()
    assert int(n_inl) > 0
