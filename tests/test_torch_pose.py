"""The port's SE(3) helpers, closed-form inverses and pose LM against
airdos_tpu (CPU).

Inputs come from numpy with a seed.  Stated tolerances:
- SE(3)/SO(3) maps and inv6x6: atol 1e-5 (float32 summation order);
- pose_optimize: rotation within 1e-4 (Frobenius), translation within
  1e-4 m, inlier masks >= 99% equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airdos_tpu.geometry.se3 as jse3
import airdos_tpu.solvers.smallmat as jsm
from airdos_tpu.solvers.pose_opt import pose_optimize as jax_pose_optimize
import airdos_tpu_torch.geometry.se3 as tse3
import airdos_tpu_torch.solvers.smallmat as tsm
from airdos_tpu_torch.solvers.pose_opt import pose_optimize
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _tangents(rng, n, rot_scale):
    xi = rng.normal(0, 1, (n, 6)).astype(np.float32)
    xi[:, 3:] *= rot_scale
    return xi


@pytest.mark.parametrize("rot_scale", [1e-5, 0.05, 1.0])
def test_se3_exp_log_match_jax(rng, rot_scale):
    xi = _tangents(rng, 64, rot_scale)
    Rt, tt = tse3.se3_exp(_t(xi))
    Rj, tj = jse3.se3_exp(jnp.asarray(xi))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-5)
    np.testing.assert_allclose(tse3.se3_log(Rt, tt).numpy(),
                               np.asarray(jse3.se3_log(Rj, tj)), atol=1e-4)


def test_so3_log_near_pi_matches_jax(rng):
    axis = rng.normal(size=(16, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    w = (axis * (np.pi - 1e-4)).astype(np.float32)
    R = jse3.so3_exp(jnp.asarray(w))
    np.testing.assert_allclose(tse3.so3_log(_t(R)).numpy(),
                               np.asarray(jse3.so3_log(R)), atol=1e-4)


def test_compose_inverse_hat_match_jax(rng):
    Ra, ta = jse3.se3_exp(jnp.asarray(_tangents(rng, 8, 0.5)))
    Rb, tb = jse3.se3_exp(jnp.asarray(_tangents(rng, 8, 0.5)))
    for got, want in zip(tse3.se3_compose(_t(Ra), _t(ta), _t(Rb), _t(tb)),
                         jse3.se3_compose(Ra, ta, Rb, tb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for got, want in zip(tse3.se3_inverse(_t(Ra), _t(ta)),
                         jse3.se3_inverse(Ra, ta)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    w = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tse3.so3_hat(_t(w)).numpy(),
                                  np.asarray(jse3.so3_hat(jnp.asarray(w))))


def test_numpy_helpers_are_the_jax_packages(rng):
    xi = rng.normal(0, 0.3, 6)
    R, t = tse3.se3_exp_np(xi)
    Rj, tj = jse3.se3_exp_np(xi)
    np.testing.assert_array_equal(R, Rj)
    np.testing.assert_array_equal(t, tj)
    np.testing.assert_array_equal(tse3.se3_log_np(R, t), jse3.se3_log_np(R, t))
    noisy = R + rng.normal(0, 1e-3, (3, 3))
    np.testing.assert_array_equal(tse3.project_so3_np(noisy),
                                  jse3.project_so3_np(noisy))


def test_inv6x6_matches_jax_and_inverts(rng):
    A = rng.normal(size=(32, 6, 6))
    M = (A @ np.swapaxes(A, -1, -2) + 6 * np.eye(6)).astype(np.float32)
    got = tsm.inv6x6(_t(M)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsm.inv6x6(jnp.asarray(M))),
                               atol=1e-5)
    np.testing.assert_allclose(got @ M, np.broadcast_to(np.eye(6), M.shape),
                               atol=1e-4)


def _pose_problem(rng, n=300, n_mono=30, outlier_frac=0.1):
    fx = fy = 500.0
    cx, cy, bf = 320.0, 180.0, 250.0
    xw = rng.uniform([-5, -3, 4], [5, 3, 25], (n, 3)).astype(np.float32)
    xi_gt = np.array([0.1, -0.05, 0.2, 0.02, -0.03, 0.01], np.float32)
    Rgt, tgt = (np.asarray(a, np.float64) for a in jse3.se3_exp(jnp.asarray(xi_gt)))
    xc = xw @ Rgt.T + tgt
    z = xc[:, 2]
    u = fx * xc[:, 0] / z + cx
    v = fy * xc[:, 1] / z + cy
    obs = np.stack([u, v, u - bf / z], axis=1).astype(np.float32)
    obs[:, :2] += rng.normal(0, 0.3, (n, 2))
    n_out = int(n * outlier_frac)
    out_idx = rng.choice(n, n_out, replace=False)
    obs[out_idx, :2] += rng.uniform(20, 60, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    obs[:n_mono, 2] = -1.0
    inv_sigma2 = (1.0 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.uniform(size=n) < 0.95
    xi0 = xi_gt + np.array([0.05, 0.05, -0.08, 0.01, 0.02, -0.015], np.float32)
    return xi0, xw, obs, inv_sigma2, valid, (fx, fy, cx, cy, bf)


@pytest.mark.parametrize("prior", [(0.0, 0.0), (400.0, 400.0)])
@pytest.mark.parametrize("n_mono", [0, 30])
def test_pose_optimize_matches_jax(rng, prior, n_mono):
    xi0, xw, obs, isig, valid, cam = _pose_problem(rng, n_mono=n_mono)
    R0, t0 = jse3.se3_exp(jnp.asarray(xi0))
    ref = jax_pose_optimize(R0, t0, jnp.asarray(xw), jnp.asarray(obs),
                            jnp.asarray(isig), jnp.asarray(valid), *cam,
                            prior_w_rot=prior[0], prior_w_trans=prior[1])
    got = pose_optimize(_t(R0), _t(t0), _t(xw), _t(obs), _t(isig),
                        torch.from_numpy(valid), *cam,
                        prior_w_rot=prior[0], prior_w_trans=prior[1])
    assert np.linalg.norm(got.R.numpy() - np.asarray(ref.R)) < 1e-4
    assert np.abs(got.t.numpy() - np.asarray(ref.t)).max() < 1e-4
    inl_ref = np.asarray(ref.inlier)
    assert np.mean(got.inlier.numpy() == inl_ref) >= 0.99
    assert int(got.n_inliers) == int(got.inlier.sum())
    assert inl_ref.sum() > 200
