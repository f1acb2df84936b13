"""The port's loop-closing and relocalization solvers against airdos_tpu
(CPU), on identical numpy inputs made from a seed.  Stated tolerances:

- sim3_exp / sim3_log in each regime of the V matrix: within 1e-5.
- horn_align (SE3 and Sim3), noisy correspondences: R within 1e-5, t
  within 1e-5 m, s within 1e-5 (a 4x4 eigenproblem in float32; LAPACK
  builds differ in the last bits).
- epnp_pose: R within 1e-4, t within 1e-4 m.  Each hypothesis's pose
  comes from the null space of M^T M, a float32 eigenproblem whose
  smallest eigenvalues differ between LAPACK builds; the pose's error to
  the truth is ~1e-3, far above that.
- epnp_ransac and sim3_ransac on the same samples: each sim3 hypothesis
  of three distinct points within 5e-4 (three points with 1 cm noise
  make a poorly conditioned 4x4 eigenproblem), the same best
  hypothesis index (the first of the largest count, both packages'
  argmax), the same inlier mask exactly, and the final pose within 1e-4.
- optimize_sim3: R and t within 1e-4, the same inliers exactly.
- optimize_essential_graph: the reverse-mode Jacobians within 1e-4 of
  jax.jacfwd's on the test's edge table; the solved poses within
  1e-4 after 20 LM steps (float32 Cholesky of the 84 x 84 system).
- global_bundle_adjust on tests/test_global_ba.py's small problem and on
  a 40-keyframe slice of its drifting corridor: cameras within 1e-4,
  points within 1e-3 m where observed twice or more, edge inliers equal.
  The CG's dot products sum in another order than XLA's, so bit equality
  is not expected.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airdos_tpu.geometry.se3 import se3_exp as jax_se3_exp
from airdos_tpu.geometry.se3 import so3_exp as jax_so3_exp
from airdos_tpu.solvers import pose_graph as jpg
from airdos_tpu.solvers.align import horn_align as jax_horn
from airdos_tpu.solvers.epnp import epnp_pose as jax_epnp_pose
from airdos_tpu.solvers.epnp import epnp_ransac as jax_epnp_ransac
from airdos_tpu.solvers.global_ba import global_bundle_adjust as jax_gba
from airdos_tpu.solvers.sim3 import optimize_sim3 as jax_opt_sim3
from airdos_tpu.solvers.sim3 import sim3_ransac as jax_sim3_ransac
from airdos_tpu_torch.ops import segment_kernels
from airdos_tpu_torch.solvers import global_ba as tgba
from airdos_tpu_torch.solvers import pose_graph as tpg
from airdos_tpu_torch.solvers.align import horn_align
from airdos_tpu_torch.solvers.epnp import epnp_pose, epnp_ransac
from airdos_tpu_torch.solvers.sim3 import optimize_sim3, sim3_ransac

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_local_ba import make_problem  # noqa: E402
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)

FX = FY = 400.0
CX, CY = 160.0, 120.0


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rot(w):
    return np.asarray(jax_so3_exp(jnp.asarray(w, jnp.float32)))


def _project(x):
    return np.stack([FX * x[:, 0] / x[:, 2] + CX,
                     FY * x[:, 1] / x[:, 2] + CY], axis=1).astype(np.float32)


@pytest.mark.parametrize("regime", ["general", "small_sigma", "small_theta",
                                    "identity"])
def test_sim3_exp_log_match_jax(regime):
    """Sim(3) exp and log in each regime of the V matrix: the port builds
    V once, airdos_tpu probes sim3_exp column by column; within 1e-5."""
    from airdos_tpu.geometry.se3 import sim3_exp as jax_sim3_exp
    from airdos_tpu.geometry.se3 import sim3_log as jax_sim3_log
    from airdos_tpu_torch.geometry.se3 import sim3_exp, sim3_log
    rng = np.random.default_rng(8)
    xi = rng.normal(0, 0.5, (64, 7)).astype(np.float32)
    if regime in ("small_sigma", "identity"):
        xi[:, 6] *= 1e-7
    if regime in ("small_theta", "identity"):
        xi[:, 3:6] *= 1e-5
    want = jax_sim3_exp(jnp.asarray(xi))
    got = sim3_exp(_t(xi))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(sim3_log(*got).numpy(),
                               np.asarray(jax_sim3_log(*want)), atol=1e-5)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_horn_align_matches_jax(fix_scale):
    rng = np.random.default_rng(3)
    P2 = rng.uniform(-2, 2, (3, 30, 3)).astype(np.float32)
    R = _rot([0.1, -0.4, 0.2])
    P1 = (1.3 * np.einsum("ij,hnj->hni", R, P2) + [0.5, -0.2, 1.0] +
          rng.normal(0, 0.01, P2.shape)).astype(np.float32)
    w = rng.uniform(0.5, 1.0, (3, 30)).astype(np.float32)
    want = jax_horn(jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(w),
                    fix_scale=fix_scale)
    got = horn_align(_t(P1), _t(P2), _t(w), fix_scale=fix_scale)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def _pnp_data(rng, n=60, n_out=12):
    pw = rng.uniform([-3, -2, 4], [3, 2, 12], (n, 3)).astype(np.float32)
    R = _rot([0.05, 0.2, -0.1])
    t = np.array([0.3, -0.1, 0.4], np.float32)
    uv = _project(pw @ R.T + t) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    out = rng.choice(n, n_out, replace=False)
    uv[out] += rng.uniform(20, 60, (n_out, 2)).astype(np.float32)
    return pw, uv.astype(np.float32), R, t


def test_epnp_pose_matches_jax():
    rng = np.random.default_rng(4)
    pw, uv, R, t = _pnp_data(rng, n_out=0)
    w = np.ones(len(pw), np.float32)
    Rj, tj = jax_epnp_pose(jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(w),
                           FX, FY, CX, CY)
    Rt, tt = epnp_pose(_t(pw)[None], _t(uv)[None], _t(w)[None],
                       FX, FY, CX, CY)
    np.testing.assert_allclose(Rt[0].numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(tj), atol=1e-4)
    assert np.abs(Rt[0].numpy() - R).max() < 1e-2


def test_epnp_ransac_matches_jax():
    rng = np.random.default_rng(5)
    pw, uv, R, t = _pnp_data(rng)
    n = len(pw)
    max_err2 = np.full(n, 5.991, np.float32)
    samples = rng.integers(0, n, (256, 4)).astype(np.int32)
    want = jax_epnp_ransac(jnp.asarray(pw), jnp.asarray(uv),
                           jnp.ones(n, bool), jnp.asarray(max_err2),
                           jnp.asarray(samples), FX, FY, CX, CY)
    got = epnp_ransac(_t(pw), _t(uv), torch.ones(n, dtype=torch.bool),
                      _t(max_err2), _t(samples), FX, FY, CX, CY)
    # airdos_tpu's best hypothesis, from its per-hypothesis poses
    Rs, ts = jax.vmap(lambda i: jax_epnp_pose(
        jnp.asarray(pw)[i], jnp.asarray(uv)[i], jnp.ones(4, jnp.float32),
        FX, FY, CX, CY))(jnp.asarray(samples))
    xc = np.einsum("hij,nj->hni", np.asarray(Rs), pw) + \
        np.asarray(ts)[:, None, :]
    err2 = ((FX * xc[..., 0] / xc[..., 2] + CX - uv[:, 0]) ** 2 +
            (FY * xc[..., 1] / xc[..., 2] + CY - uv[:, 1]) ** 2)
    counts = ((err2 < max_err2) & (xc[..., 2] > 0)).sum(1)
    assert int(got.best) == int(np.argmax(counts))
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) >= n - 14
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)


def test_ransac_argmax_keeps_the_first_maximum():
    """Ties between hypotheses go to the lowest index, as jnp.argmax."""
    counts = torch.tensor([3, 7, 2, 7, 7])
    assert int(torch.argmax(counts)) == int(jnp.argmax(jnp.asarray(counts)))


def _sim3_data(rng, n=50, n_out=10):
    x2 = rng.uniform([-3, -2, 4], [3, 2, 15], (n, 3)).astype(np.float32)
    R = _rot([0.05, 0.3, -0.1])
    t = np.array([0.5, -0.2, 0.8], np.float32)
    x1 = (x2 @ R.T + t + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    out = rng.choice(n, n_out, replace=False)
    x1[out] += rng.uniform(1, 3, (n_out, 3)).astype(np.float32)
    return x1, x2, R, t


def test_sim3_ransac_matches_jax():
    rng = np.random.default_rng(6)
    x1, x2, R, t = _sim3_data(rng)
    n = len(x1)
    samples = rng.integers(0, n, (256, 3)).astype(np.int32)
    gate = np.full(n, 9.21 * 4, np.float32)
    want = jax_sim3_ransac(jnp.asarray(x1), jnp.asarray(x2),
                           jnp.ones(n, bool), jnp.asarray(samples),
                           jnp.asarray(gate), jnp.asarray(gate),
                           FX, FY, CX, CY, fix_scale=True)
    got = sim3_ransac(_t(x1), _t(x2), torch.ones(n, dtype=torch.bool),
                      _t(samples), _t(gate), _t(gate), FX, FY, CX, CY)
    # airdos_tpu's hypotheses: a sample that repeats a point is degenerate
    # (its N matrix has a repeated top eigenvalue, whose eigenvector each
    # LAPACK build picks its own way), so poses are held on the others;
    # the best index is airdos_tpu's argmax over its own inlier counts
    Rs, ts, _ = jax_horn(jnp.asarray(x1)[samples], jnp.asarray(x2)[samples])
    Rh, th_, _ = horn_align(_t(x1)[samples.astype(np.int64)],
                            _t(x2)[samples.astype(np.int64)])
    distinct = np.array([len(set(s)) == 3 for s in samples])
    np.testing.assert_allclose(Rh.numpy()[distinct], np.asarray(Rs)[distinct],
                               atol=5e-4)
    np.testing.assert_allclose(th_.numpy()[distinct],
                               np.asarray(ts)[distinct], atol=5e-4)
    Rs, ts = np.asarray(Rs), np.asarray(ts)
    p1 = np.einsum("nj,hij->hni", x2, Rs) + ts[:, None, :]
    p2 = np.einsum("hnj,hji->hni", x1[None] - ts[:, None, :], Rs)
    e1 = ((_project(p1.reshape(-1, 3)) - np.tile(_project(x1), (256, 1))) ** 2
          ).sum(1).reshape(256, n)
    e2 = ((_project(p2.reshape(-1, 3)) - np.tile(_project(x2), (256, 1))) ** 2
          ).sum(1).reshape(256, n)
    counts = ((e1 < gate) & (e2 < gate)).sum(1)
    assert int(got.best) == int(np.argmax(counts))
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) >= 35
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)


def test_optimize_sim3_matches_jax():
    rng = np.random.default_rng(7)
    n = 40
    x2 = rng.uniform([-3, -2, 4], [3, 2, 12], (n, 3)).astype(np.float32)
    R_gt = _rot([0.02, 0.2, -0.05])
    t_gt = np.array([0.3, -0.1, 0.5], np.float32)
    x1 = (x2 @ R_gt.T + t_gt).astype(np.float32)
    obs1 = _project(x1) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    obs2 = _project(x2) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    obs1[:3] += 30.0                                # three outliers
    R0 = (_rot([0.0, 0.03, 0.0]) @ R_gt).astype(np.float32)
    t0 = t_gt + np.array([0.05, -0.03, 0.02], np.float32)
    sig = np.ones(n, np.float32)
    want = jax_opt_sim3(jnp.asarray(R0), jnp.asarray(t0), jnp.float32(1.0),
                        jnp.asarray(x1), jnp.asarray(obs1), jnp.asarray(sig),
                        jnp.asarray(x2), jnp.asarray(obs2), jnp.asarray(sig),
                        jnp.ones(n, bool), FX, FY, CX, CY)
    got = optimize_sim3(_t(R0), _t(t0), 1.0, _t(x1), _t(obs1), _t(sig),
                        _t(x2), _t(obs2), _t(sig),
                        torch.ones(n, dtype=torch.bool), FX, FY, CX, CY)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[4]) == int(want[4]) == n - 3


def _pose_graph_problem():
    """tests/test_loop_solvers.py's drifted 12-keyframe chain with one
    loop edge back to the start."""
    K = 12
    gt_R, gt_t, est_R, est_t = [], [], [], []
    for k in range(K):
        R, t = jax_se3_exp(jnp.asarray([0.4 * k, 0, 0, 0, 0.12 * k, 0],
                                       jnp.float32))
        gt_R.append(np.asarray(R))
        gt_t.append(np.asarray(t))
        dxi = np.concatenate([0.02 * k * np.ones(3),
                              0.004 * k * np.ones(3)]).astype(np.float32)
        dR, dt = jax_se3_exp(jnp.asarray(dxi))
        est_R.append(np.asarray(dR) @ gt_R[k])
        est_t.append(np.asarray(dR) @ gt_t[k] + np.asarray(dt))
    e_i, e_j, Rm, tm = [], [], [], []
    for a, b, Rs, ts in [(k, k + 1, est_R, est_t) for k in range(K - 1)] + \
            [(K - 1, 0, gt_R, gt_t)]:
        Rrel = Rs[b] @ Rs[a].T
        e_i.append(a)
        e_j.append(b)
        Rm.append(Rrel)
        tm.append(ts[b] - Rrel @ ts[a])
    fixed = np.zeros(K, bool)
    fixed[0] = True
    E = len(e_i)
    return (np.stack(est_R).astype(np.float32),
            np.stack(est_t).astype(np.float32), np.ones(K, np.float32),
            fixed, np.asarray(e_i, np.int32), np.asarray(e_j, np.int32),
            np.stack(Rm).astype(np.float32), np.stack(tm).astype(np.float32),
            np.ones(E, np.float32), np.ones(E, bool)), np.stack(gt_t)


def test_essential_graph_jacobians_match_jax():
    args, _ = _pose_graph_problem()
    kR, kt, ks, _, ei, ej, Rm, tm, sm, _ = args
    per_edge = (kR[ei], kt[ei], ks[ei], kR[ej], kt[ej], ks[ej], Rm, tm, sm)
    zero7 = jnp.zeros(7, jnp.float32)

    # airdos_tpu's residual and Jacobians (its edge_system, unjitted)
    def residual_fn(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm_, tm_, sm_):
        def perturb(R, t, s, xi):
            return (jnp.matmul(jax_so3_exp(xi[3:6]), R, precision="highest"),
                    t + xi[:3], s * jnp.exp(xi[6]))
        return jpg._edge_residual(*perturb(Ri, ti, si, xi_i),
                                  *perturb(Rj, tj, sj, xi_j), Rm_, tm_, sm_)

    jargs = tuple(jnp.asarray(a) for a in per_edge)
    e_j = jax.vmap(residual_fn, in_axes=(None, None) + (0,) * 9)(
        zero7, zero7, *jargs)
    Ji_j = jax.vmap(jax.jacfwd(residual_fn, argnums=0),
                    in_axes=(None, None) + (0,) * 9)(zero7, zero7, *jargs)
    Jj_j = jax.vmap(jax.jacfwd(residual_fn, argnums=1),
                    in_axes=(None, None) + (0,) * 9)(zero7, zero7, *jargs)
    e_t, Ji_t, Jj_t = tpg.edge_jacobians(*(_t(a) for a in per_edge))
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), atol=1e-5)
    np.testing.assert_allclose(Ji_t.numpy(), np.asarray(Ji_j), atol=1e-4)
    np.testing.assert_allclose(Jj_t.numpy(), np.asarray(Jj_j), atol=1e-4)


def test_essential_graph_matches_jax(monkeypatch):
    args, gt_t = _pose_graph_problem()
    want = jpg.optimize_essential_graph(*(jnp.asarray(a) for a in args))
    calls = []
    real = tpg.segment_sum
    monkeypatch.setattr(tpg, "segment_sum",
                        lambda *a: calls.append(1) or real(*a))
    got = tpg.optimize_essential_graph(*(_t(a) for a in args))
    assert len(calls) == 20            # one segment sum per GN step
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    err_before = np.linalg.norm(args[1][-1] - gt_t[-1])
    err_after = np.linalg.norm(got[1][-1].numpy() - gt_t[-1])
    assert err_after < 0.5 * err_before


def _corridor(rng, C=40, P=600):
    """tests/test_global_ba.py's drifting corridor, C keyframes."""
    fx = fy = 300.0
    cx, cy, bf = 160.0, 120.0, 60.0
    cam_t_gt = np.stack([np.array([0.01 * c, 0.0, 0.25 * c])
                         for c in range(C)]).astype(np.float32)
    pts_gt = np.stack([rng.uniform(-6, 6, P), rng.uniform(-4, 4, P),
                       rng.uniform(2, 0.25 * C + 10, P)],
                      axis=1).astype(np.float32)
    e_cam, e_pt, e_obs = [], [], []
    for c in range(C):
        xc = pts_gt - cam_t_gt[c]
        z = xc[:, 2]
        u = fx * xc[:, 0] / np.where(z > 0.1, z, 1) + cx
        v = fy * xc[:, 1] / np.where(z > 0.1, z, 1) + cy
        ok = (z > 1.0) & (z < 25.0) & (u > 0) & (u < 320) & (v > 0) & (v < 240)
        sel = np.nonzero(ok)[0]
        sel = sel[rng.permutation(len(sel))[:60]]
        for p in sel:
            e_cam.append(c)
            e_pt.append(p)
            e_obs.append([u[p] + rng.normal(0, 0.2), v[p] + rng.normal(0, 0.2),
                          u[p] - bf / z[p] + rng.normal(0, 0.2)])
    cam_t_n = cam_t_gt + np.linspace(0, 1, C)[:, None] * \
        np.array([0.2, 0.1, 0.15], np.float32)
    cam_R_n = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    for c in range(1, C):
        cam_R_n[c] = _rot([0.0, 0.0005 * c, 0.0])
    pts_n = pts_gt + rng.normal(0, 0.05, pts_gt.shape).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    tcw_n = -np.einsum("cij,cj->ci", cam_R_n, cam_t_n).astype(np.float32)
    E = len(e_cam)
    return (cam_R_n, tcw_n, fixed, pts_n, np.ones(P, bool),
            np.asarray(e_cam, np.int32), np.asarray(e_pt, np.int32),
            np.asarray(e_obs, np.float32), np.ones(E, np.float32),
            np.ones(E, bool), fx, fy, cx, cy, bf)


def _small_gba_problem(rng):
    fx, fy, cx, cy, bf, pts_gt, cams, e_cam, e_pt, e_obs = make_problem(
        rng, C=5, P=80)
    C, P, E = len(cams), len(pts_gt), len(e_cam)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    pts_n = pts_gt + rng.normal(0, 0.05, pts_gt.shape).astype(np.float32)
    return (np.stack([c[0] for c in cams]), np.stack([c[1] for c in cams]),
            fixed, pts_n, np.ones(P, bool), e_cam, e_pt, e_obs,
            np.ones(E, np.float32), np.ones(E, bool), fx, fy, cx, cy, bf)


@pytest.mark.parametrize("problem,iters", [("small", (4, 8)),
                                           ("corridor", (2, 3))])
def test_global_bundle_adjust_matches_jax(problem, iters, monkeypatch):
    rng = np.random.default_rng(0)
    args = _small_gba_problem(rng) if problem == "small" else _corridor(rng)
    arrays, scalars = args[:10], args[10:]
    kw = dict(iters1=iters[0], iters2=iters[1], cg_iters=48)
    want = jax_gba(*(jnp.asarray(a) for a in arrays), *scalars, **kw)
    calls = []
    real = tgba.segment_sum
    monkeypatch.setattr(tgba, "segment_sum",
                        lambda *a: calls.append(1) or real(*a))
    got = tgba.global_bundle_adjust(*(_t(a) for a in arrays), *scalars, **kw)
    assert len(calls) == tgba.launches_per_step(48)["segment_sum"] * \
        sum(iters) == 4 * sum(iters)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    np.testing.assert_array_equal(got.edge_inlier.numpy(),
                                  np.asarray(want.edge_inlier))
    n_obs = np.bincount(arrays[6], minlength=arrays[3].shape[0])
    twice = n_obs >= 2
    gap = np.linalg.norm(got.points.numpy() - np.asarray(want.points), axis=1)
    assert gap[twice].max() < 1e-3, gap[twice].max()


def test_global_ba_sums_no_padding_edge():
    """Edges outside e_valid & point_valid join no segment."""
    rng = np.random.default_rng(1)
    args = list(_small_gba_problem(rng))
    E = len(args[5])
    pad = 16
    for i, fill in ((5, 0), (6, 0), (8, 1.0), (9, False)):
        args[i] = np.concatenate([args[i], np.full(pad, fill, args[i].dtype)])
    args[7] = np.concatenate([args[7], np.full((pad, 3), -1.0, np.float32)])
    seen = []
    real = segment_kernels.make_segments
    tgba_make = tgba.make_segments
    try:
        tgba.make_segments = lambda key, n, keep=None: seen.append(
            keep.clone()) or real(key, n, keep)
        res = tgba.global_bundle_adjust(*(_t(a) if isinstance(a, np.ndarray)
                                          else a for a in args), iters1=1,
                                        iters2=1)
    finally:
        tgba.make_segments = tgba_make
    assert all(not k[E:].any() for k in seen) and len(seen) == 2
    assert not res.edge_inlier[E:].any()


def test_global_ba_chunk_schedule_matches_jax(monkeypatch):
    """GlobalBA's schedule: four solver calls of five steps, the first
    with 2 Huber + 3 plain steps, each call a fresh solve (airdos_tpu
    slam/ba_driver.py:1256-1274); 4 segment sums a step, 80 in all."""
    from airdos_tpu_torch.slam import ba_driver as tbd
    rng = np.random.default_rng(2)
    args = _corridor(rng, C=24, P=400)
    arrays, scalars = args[:10], args[10:]
    R, t, ps = (jnp.asarray(a) for a in (arrays[0], arrays[1], arrays[3]))
    for ci in range(4):
        i1 = 2 if ci == 0 else 0
        res = jax_gba(R, t, jnp.asarray(arrays[2]), ps,
                      *(jnp.asarray(a) for a in arrays[4:]), *scalars,
                      iters1=i1, iters2=5 - i1, cg_iters=48)
        R, t, ps = res.R, res.t, res.points
    calls = []
    real = tgba.segment_sum
    monkeypatch.setattr(tgba, "segment_sum",
                        lambda *a: calls.append(1) or real(*a))
    Rt, tt, pt = tbd.solve_global_ba(*(_t(a) for a in arrays), *scalars)
    assert len(calls) == 80
    np.testing.assert_allclose(Rt.numpy(), np.asarray(R), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(t), atol=1e-4)
    twice = np.bincount(arrays[6], minlength=len(arrays[3])) >= 2
    gap = np.linalg.norm(pt.numpy() - np.asarray(ps), axis=1)
    assert gap[twice].max() < 1e-3, gap[twice].max()


def test_global_ba_at_300_keyframes_matches_jax():
    """The corridor at 300 keyframes (the test's drift reached at the
    300th) in GlobalBA's schedule.  Both packages cut the reprojection
    chi2 a hundredfold and both end FARTHER from the truth than they
    start: 48 PCG iterations a step do not carry the correction along a
    chain this long, a property of airdos_tpu's solver, not of the port
    (PERF.md, section 6).  The truncated CG amplifies rounding there: the mean
    centre error is ~0.15 m in airdos_tpu, ~0.18 m in the port, ~0.12 m in
    a float64 run of the port, so the packages are held within 25% of
    each other; with 300 CG iterations and 40 steps the port's float64
    run brings the error below a quarter of the start, as
    tests/test_global_ba.py asks at 200 keyframes."""
    from airdos_tpu_torch.slam import ba_driver as tbd
    from airdos_tpu_torch.solvers.local_ba import _proj_residual
    rng = np.random.default_rng(4)
    args = list(_corridor(rng, C=300, P=6000))
    C = 300
    yaw = 0.1 * np.arange(C) / C
    ctr_n = -np.einsum("cji,cj->ci", args[0], args[1])
    R_n = np.zeros((C, 3, 3), np.float32)
    R_n[:, 0, 0] = R_n[:, 2, 2] = np.cos(yaw)
    R_n[:, 0, 2], R_n[:, 2, 0] = np.sin(yaw), -np.sin(yaw)
    R_n[:, 1, 1] = 1.0
    args[0] = R_n
    args[1] = -np.einsum("cij,cj->ci", R_n, ctr_n).astype(np.float32)
    arrays, scalars = args[:10], args[10:]
    gt = np.stack([0.01 * np.arange(C), np.zeros(C), 0.25 * np.arange(C)], 1)

    def err(R, t):
        ctr = -np.einsum("cji,cj->ci", np.asarray(R, np.float64),
                         np.asarray(t, np.float64))
        return np.linalg.norm(ctr - gt, axis=1).mean()

    def chi2(R, t, p):
        ec, ep = _t(arrays[5]).long(), _t(arrays[6]).long()
        e, _, _, _ = _proj_residual(R[ec], t[ec], p[ep],
                                    _t(arrays[7]).to(p.dtype), *scalars,
                                    _t(arrays[7])[:, 2] >= 0)
        return float((e * e).sum())

    R, t, ps = (jnp.asarray(a) for a in (arrays[0], arrays[1], arrays[3]))
    for ci in range(4):
        i1 = 2 if ci == 0 else 0
        res = jax_gba(R, t, jnp.asarray(arrays[2]), ps,
                      *(jnp.asarray(a) for a in arrays[4:]), *scalars,
                      iters1=i1, iters2=5 - i1, cg_iters=48)
        R, t, ps = res.R, res.t, res.points
    Rt, tt, pt = tbd.solve_global_ba(*(_t(a) for a in arrays), *scalars)
    chi0 = chi2(*(_t(arrays[i]) for i in (0, 1, 3)))
    assert chi2(Rt, tt, pt) < 1e-2 * chi0
    assert chi2(*(_t(np.asarray(a)) for a in (R, t, ps))) < 1e-2 * chi0
    e0, ej, et = err(arrays[0], arrays[1]), err(R, t), err(Rt, tt)
    assert ej > e0 and et > e0 and abs(et - ej) < 0.25 * ej, (e0, ej, et)
    a64 = [_t(a).double() if a.dtype == np.float32 else _t(a)
           for a in arrays]
    R64, t64, _ = tbd.solve_global_ba(*a64, *scalars, n_iters=40,
                                      cg_iters=300)
    assert err(R64, t64) < 0.25 * e0, (e0, err(R64, t64))
