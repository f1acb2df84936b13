"""The BAs' Gauss-Newton kernel modules against airdos_tpu (CPU).

The static edges (ops/ba_static.py, csrc/ba_static.cu), the landmark Schur
(ops/ba_points.py, csrc/ba_points.cu) and the human edge families
(ops/ba_human.py, csrc/ba_human.cu) run here through their dispatchers on
CPU tensors, that is through their plain versions, and the fixed-order LM
cost (ops/lm_cost.py, the order of their cost-sum modes) through its plain
sum; the kernels run in
tests/test_torch_cuda.py and chip_smoke.py on the card, bit-equal to
them.  Inputs are made with numpy from a seed and handed to both
packages.  Stated tolerances, all relative to the largest magnitude of
the quantity compared (float32 results whose sums run in other orders;
the port rounds the normal-equation entries, the landmark inverses and
the back-substitution once from float64):
- residuals and depths: 1e-5; chi2 and robust costs: 1e-4 (a residual
  is the difference of an observation and a prediction of hundreds of
  pixels, so it carries a few ulps of those, ~1e-4 px, which its square
  doubles relative to the largest);
- Jacobian products (J^T W J, J^T W e, the coupling rows): 1e-4 (JAX's
  Jacobians round differently term by term, and the products square
  that);
- damped landmark inverses and Aagg, the back-substitution: 1e-4;
- the LM cost sums: 1e-5 against jnp.sum; the fixed order itself is
  checked exactly on a hand-made case.
The pyramid's mask erosion (repaired in the same change) is held exactly
against airdos_tpu at a window other than 10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airdos_tpu.ops.pyramid as jpyr
from airdos_tpu.geometry.se3 import so3_hat as jax_so3_hat
from airdos_tpu.solvers.human_ba import _proj_rj
from airdos_tpu.solvers.local_ba import _proj_residual as jax_proj_residual
from airdos_tpu.solvers.smallmat import inv3x3 as jax_inv3x3
import airdos_tpu_torch.ops.ba_human as bh
import airdos_tpu_torch.ops.ba_points as bp
import airdos_tpu_torch.ops.ba_static as bs
import airdos_tpu_torch.ops.lm_cost as lc
import airdos_tpu_torch.ops.pyramid as tpyr
import airdos_tpu_torch.solvers.human_ba as thba
import airdos_tpu_torch.solvers.local_ba as tlba
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)

CAM = (458.654, 457.296, 367.215, 248.375, 50.0)   # fx, fy, cx, cy, bf


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    err = np.abs(got - want).max(initial=0.0) / scale
    assert err < rtol, (what, err)


def _rotations(rng, n):
    w = rng.normal(0, 0.2, (n, 3))
    out = []
    for v in w:
        th = np.linalg.norm(v)
        k = v / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        out.append(np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K)
    return np.asarray(out, np.float32)


def _static_problem(rng, C=5, P=60, E=400, mono=0.3, pad=0.1):
    R = _rotations(rng, C)
    t = rng.normal(0, 0.3, (C, 3)).astype(np.float32)
    pts = rng.uniform([-3, -2, 4], [3, 2, 12], (P, 3)).astype(np.float32)
    e_cam = rng.integers(0, C, E).astype(np.int32)
    e_pt = rng.integers(0, P, E).astype(np.int32)
    xc = np.einsum("eij,ej->ei", R[e_cam], pts[e_pt]) + t[e_cam]
    fx, fy, cx, cy, bf = CAM
    u = fx * xc[:, 0] / xc[:, 2] + cx
    v = fy * xc[:, 1] / xc[:, 2] + cy
    obs = np.stack([u, v, u - bf / xc[:, 2]], 1)
    obs += rng.normal(0, 2.0, obs.shape)           # some edges past delta
    obs[rng.random(E) < mono, 2] = -1.0
    obs = obs.astype(np.float32)
    info = rng.uniform(0.3, 1.5, E).astype(np.float32)
    active = (rng.random(E) > pad).astype(np.float32)
    return R, t, pts, e_cam, e_pt, obs, info, active


def _jax_static(R, t, pts, e_cam, e_pt, obs, info, active, scale, huber):
    """airdos_tpu's per-edge pieces (local_ba.py:43 and gn_step's weights
    and einsums, the human BA's static scale as SigmaStatic)."""
    is_stereo = jnp.asarray(obs[:, 2] >= 0)
    e, Jc, Jp, z = jax_proj_residual(
        jnp.asarray(R)[e_cam], jnp.asarray(t)[e_cam], jnp.asarray(pts)[e_pt],
        jnp.asarray(obs), *CAM, is_stereo)
    chi2 = jnp.sum(e * e, axis=-1) * info * scale
    delta = jnp.where(is_stereo, 2.795483, 2.447749)
    sq = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    w_h = jnp.where(huber & (sq > delta), delta / sq, 1.0)
    rho = jnp.where(huber & (sq > delta), 2 * delta * sq - delta * delta, chi2)
    w = info * scale * w_h * active
    E = obs.shape[0]
    cam = jnp.concatenate([jnp.einsum("eik,e,eil->ekl", Jc, w, Jc).reshape(E, 36),
                           -jnp.einsum("eik,e,ei->ek", Jc, w, e)], axis=1)
    pt = jnp.concatenate([jnp.einsum("eik,e,eil->ekl", Jp, w, Jp).reshape(E, 9),
                          -jnp.einsum("eik,e,ei->ek", Jp, w, e)], axis=1)
    pc = jnp.einsum("eik,e,eil->ekl", Jc, w, Jp).reshape(E, 18)
    return jax.device_get((cam, pt, pc, rho, chi2, z))


@pytest.mark.parametrize("huber,scale", [(True, 1.0), (False, 1.0),
                                         (True, 0.7)])
def test_static_edges_ref_matches_jax(huber, scale):
    rng = np.random.default_rng(11)
    args = _static_problem(rng)
    cam, pt, pc, rho, chi2, z = _jax_static(*args, scale, huber)
    R, t, pts, e_cam, e_pt, obs, info, active = (_t(a) for a in args)
    rows = bs.static_edge_blocks(R, t, pts, e_cam, e_pt, obs, info, active,
                                 CAM, scale, huber)
    cost = bs.static_edge_cost(R, t, pts, e_cam, e_pt, obs, info, CAM,
                               scale, huber)
    _close(rows.cam, cam, 1e-4, "cam rows")
    _close(rows.pt, pt, 1e-4, "pt rows")
    _close(rows.pc, pc, 1e-4, "pc rows")
    _close(cost.rho, rho, 1e-4, "rho")
    _close(cost.chi2, chi2, 1e-4, "chi2")
    _close(cost.z, z, 1e-5, "z")
    inactive = args[7] == 0
    for x in rows:
        assert np.all(x.numpy()[inactive] == 0)


def test_project_ref_matches_jax_including_behind_and_on_the_plane():
    """Points behind the camera, and points within 1e-6 of its plane (an
    identity camera, so both packages see the same depth), whose depth is
    taken as 1e-6."""
    rng = np.random.default_rng(12)
    R, t, pts, e_cam, e_pt, obs, _, _ = _static_problem(rng, E=50)
    pts = pts.copy()
    pts[e_pt[:5], 2] *= -1.0
    R[0], t[0] = np.eye(3, dtype=np.float32), 0.0
    e_cam[45:], e_pt[45:] = 0, np.arange(45, 50)
    pts[45:50, 2] = [0.0, 5e-7, -5e-7, 1e-6, -2e-6]
    e, Jc, Jp, z = jax.device_get(jax_proj_residual(
        jnp.asarray(R)[e_cam], jnp.asarray(t)[e_cam],
        jnp.asarray(pts)[e_pt], jnp.asarray(obs), *CAM,
        jnp.asarray(obs[:, 2] >= 0)))
    te, tJc, tJp, tz, _ = bs.project_ref(_t(R)[e_cam], _t(t)[e_cam],
                                         _t(pts)[e_pt], _t(obs), CAM)
    assert np.all(tz.numpy()[:5] < 0) and np.all(tz.numpy()[45:] == z[45:])
    for got, want, name in ((te, e, "e"), (tJc, Jc, "Jc"), (tJp, Jp, "Jp"),
                            (tz, z, "z")):
        _close(got[:45], want[:45], 1e-5, name)
        for i in range(45, 50):
            _close(got[i], want[i], 1e-5, f"{name} {i}")


def _landmark_problem(rng, P=50, C=6, invalid=0.2):
    J = rng.normal(0, 30, (P, 4, 3))
    Hpp = np.einsum("pik,pil->pkl", J, J)
    Hpp[:3] = np.einsum("pk,pl->pkl", J[:3, 0], J[:3, 0])   # rank 1
    bp_ = rng.normal(0, 10, (P, 3))
    pt_sums = np.concatenate([Hpp.reshape(P, 9), bp_], 1).astype(np.float32)
    wagg = rng.normal(0, 5, (P, C, 6, 3)).astype(np.float32)
    wagg[rng.random((P, C)) < 0.5] = 0.0           # cameras not seeing p
    valid = rng.random(P) > invalid
    dx_c = rng.normal(0, 1e-2, (C, 6)).astype(np.float32)
    dx_c[0] = 0.0                                  # a fixed camera
    return pt_sums, wagg, valid, dx_c


@pytest.mark.parametrize("lam", [1e-6, 3e-3, 1e2])
def test_landmark_reduce_ref_matches_jax(lam):
    rng = np.random.default_rng(13)
    pt_sums, wagg, valid, _ = _landmark_problem(rng)
    P, C = wagg.shape[:2]
    H = jnp.asarray(pt_sums[:, :9].reshape(P, 3, 3))
    eye = jnp.eye(3, dtype=jnp.float32)
    lam_j = jnp.asarray(lam, jnp.float32)
    # airdos_tpu/solvers/local_ba.py:130-140
    H = H + (lam_j * eye)[None] * jnp.maximum(
        jnp.trace(H, axis1=1, axis2=2)[:, None, None] / 3.0, 1e-3)
    H = H + 1e-6 * eye[None]
    Hinv = jnp.where(jnp.asarray(valid)[:, None, None], jax_inv3x3(H), 0.0)
    A = jnp.einsum("pckl,plm->pckm", jnp.asarray(wagg), Hinv)
    Hinv, A = jax.device_get((Hinv, A))
    got_h, got_a = bp.landmark_reduce(
        _t(pt_sums), _t(wagg.reshape(P, C * 18)), _t(valid),
        torch.tensor(lam, dtype=torch.float32))
    # the damped rank-1 blocks (points 0-2): airdos_tpu's float32 adjugate
    # cancels there, so they are held against float64 numpy instead
    _close(got_h[3:], Hinv[3:], 1e-4, "Hinv")
    _close(got_a[3:], A[3:], 1e-4, "Aagg")
    for p in range(3):
        want = np.linalg.inv(_damped(pt_sums[p, :9].reshape(3, 3), lam))
        if valid[p]:
            _close(got_h[p], want, 1e-6, f"Hinv {p}")
            _close(got_a[p], wagg[p].astype(np.float64) @ want, 1e-6,
                   f"Aagg {p}")
    assert np.all(got_h.numpy()[~valid] == 0)


def _damped(H, lam):
    """The port's float32 damping of a landmark block, as float64."""
    H = H.astype(np.float32)
    lam = np.float32(lam)
    tr = np.float32(np.float32(H[0, 0] + H[1, 1]) + H[2, 2])
    damp = np.float32(lam * max(np.float32(tr / np.float32(3.0)),
                                np.float32(1e-3)))
    out = H.astype(np.float64)
    out[np.diag_indices(3)] = (H.diagonal() + damp).astype(np.float32) \
        + np.float32(1e-6)
    return out


def test_landmark_inverse_of_a_rank_two_block_stays_finite():
    """A point seen by one mono edge: Hpp = Jp^T Jp of rank 2, damped by
    lam tr / 3 + 1e-6 at lam 8e-9; the inverse (float64, rounded once) is
    finite and inverts the damped block."""
    rng = np.random.default_rng(14)
    J = rng.normal(0, 300, (2, 3))
    H = (J.T @ J).astype(np.float32)
    pt_sums = np.concatenate([H.reshape(1, 9), np.zeros((1, 3))],
                             1).astype(np.float32)
    lam = np.float32(8.1e-9)
    hinv, _ = bp.landmark_reduce(_t(pt_sums), torch.zeros((1, 18)),
                                 torch.ones(1, dtype=torch.bool),
                                 torch.tensor(lam))
    assert np.all(np.isfinite(hinv.numpy()))
    _close(hinv[0], np.linalg.inv(_damped(H, lam)), 1e-6)


def test_landmark_backsub_ref_matches_jax():
    rng = np.random.default_rng(15)
    pt_sums, wagg, valid, dx_c = _landmark_problem(rng, C=70)  # 3 lanes deep
    P, C = wagg.shape[:2]
    hinv = rng.normal(0, 1, (P, 3, 3)).astype(np.float32)
    # airdos_tpu/solvers/local_ba.py:164-167
    WTdx = jnp.einsum("pckl,ck->pl", jnp.asarray(wagg), jnp.asarray(dx_c))
    want = jnp.einsum("plm,pm->pl", jnp.asarray(hinv),
                      jnp.asarray(pt_sums[:, 9:]) - WTdx) * valid[:, None]
    got = bp.landmark_backsub(_t(hinv), _t(pt_sums),
                              _t(wagg.reshape(P, C * 18)), _t(dx_c),
                              _t(valid))
    _close(got, jax.device_get(want), 1e-4)
    assert np.all(got.numpy()[~valid] == 0)


def test_landmark_backsub_order_is_lanes_then_a_halving_tree():
    """The camera sum: 32 lanes, each over its cameras in sequence, then
    lanes j + 16, 8, 4, 2, 1 - here with terms whose float64 sum depends
    on the order (1, 2^60, -2^60 by turns)."""
    P, C = 1, 40
    wagg = np.zeros((P, C, 6, 3), np.float32)
    vals = [1.0, 2.0 ** 60, -2.0 ** 60]
    for c in range(C):
        wagg[0, c, 0, 0] = vals[c % 3]
    dx_c = np.zeros((C, 6), np.float32)
    dx_c[:, 0] = 1.0
    lanes = np.zeros(32)
    for c in range(C):
        lanes[c % 32] = lanes[c % 32] + wagg[0, c, 0, 0]
    off = 16
    while off:
        lanes = lanes[:off] + lanes[off:2 * off]
        off //= 2
    hinv = np.eye(3, dtype=np.float32)[None]
    pt_sums = np.zeros((P, 12), np.float32)
    got = bp.landmark_backsub(_t(hinv), _t(pt_sums),
                              _t(wagg.reshape(P, C * 18)), _t(dx_c),
                              torch.ones(P, dtype=torch.bool))
    assert float(got[0, 0]) == np.float32(-lanes[0])


def _jax_human(state, tb, act, sig, huber):
    """airdos_tpu's human families (human_ba.py:188 residuals, the hw
    weights and the scatter helper's einsums of gn_step :257-301),
    flattened in scatter_keys' order."""
    camR, camt, joints, seg_len, motR, mott = (jnp.asarray(x) for x in state)
    (hp_cam, hp_joint, hp_obs, rg_j1, rg_j2, rg_seg, mo_j1, mo_j2, mo_traj,
     mo_dt) = (np.asarray(x) for x in tb)
    s_h, s_r, s_m, d_h, d_r, d_m = sig
    jflat = joints.reshape(-1, 3)
    eh, Jch, Jxh, zh = _proj_rj(camR[hp_cam], camt[hp_cam], jflat[hp_joint],
                                jnp.asarray(hp_obs), *CAM,
                                jnp.asarray(hp_obs[:, 2] >= 0))
    diff = jflat[rg_j1] - jflat[rg_j2]
    dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1) + 1e-12)
    er = dist - seg_len.reshape(-1)[rg_seg]
    Jr = diff / dist[:, None]
    Rm = motR[mo_traj]
    tm = mott[mo_traj] * jnp.asarray(mo_dt)[:, None]
    xm = jnp.einsum("eji,ej->ei", Rm, jflat[mo_j2] - tm)
    em = jflat[mo_j1] - xm
    chis = (jnp.sum(eh * eh, -1) * s_h, er * er * s_r,
            jnp.sum(em * em, -1) * s_m)

    def robust(chi, delta, base, a):
        sq = jnp.sqrt(jnp.maximum(chi, 1e-12))
        past = huber & (sq > delta)
        w = base * jnp.where(past, delta / sq, 1.0) * a
        return w, jnp.where(past, 2 * delta * sq - delta * delta, chi)

    rw = [robust(c, d, s, jnp.asarray(a)) for c, d, s, a in
          zip(chis, (d_h, d_r, d_m), (s_h, s_r, s_m), act)]
    E_m = em.shape[0]
    RmT = jnp.swapaxes(Rm, 1, 2)
    J_m = jnp.concatenate([jnp.broadcast_to(jnp.eye(3), (E_m, 3, 3)), -RmT,
                           RmT * jnp.asarray(mo_dt)[:, None, None],
                           -jax_so3_hat(xm)], axis=2)
    J_r = jnp.concatenate([Jr, -Jr, -jnp.ones_like(er)[:, None]],
                          axis=1)[:, None, :]
    J_h = jnp.concatenate([Jch, Jxh], axis=2)
    fams = ((J_h, eh), (J_r, er[:, None]), (J_m, em))
    hs = [jnp.einsum("erq,e,erp->eqp", J, w, J).reshape(-1)
          for (J, _), (w, _) in zip(fams, rw)]
    bs_ = [-jnp.einsum("erq,e,er->eq", J, w, e).reshape(-1)
           for (J, e), (w, _) in zip(fams, rw)]
    return jax.device_get((hs, bs_, [rho for _, rho in rw], chis, zh))


def _human_problem(rng, T=2, L=4, C=3):
    """2 trajectories x 4 poses seen from 3 cameras; a few joints behind
    their camera, far observations past the Huber deltas, inactive edges."""
    N = 14
    camR = _rotations(rng, C)
    camt = rng.normal(0, 0.2, (C, 3)).astype(np.float32)
    joints = rng.uniform([-1, -1, 3], [1, 1, 6], (T, L, N, 3)).astype(np.float32)
    seg_len = rng.uniform(0.2, 0.6, (T, N)).astype(np.float32)
    motR = _rotations(rng, T)
    mott = rng.normal(0, 0.5, (T, 3)).astype(np.float32)
    jo_cam = rng.integers(0, C, (T, L))
    exists = np.ones((T, L, N), bool)
    ed = thba.human_edges(_t(jo_cam), _t(rng.normal(300, 80, (T, L, N, 3))
                                         .astype(np.float32)),
                          _t(exists), _t(exists), _t(exists),
                          torch.ones(T, dtype=torch.bool),
                          _t(rng.uniform(0.1, 0.3, (T, L)).astype(np.float32)),
                          torch.ones((T, L, 5), dtype=torch.bool), C)
    obs = ed.tables.hp_obs.numpy().copy()
    obs[rng.random(len(obs)) < 0.3, 2] = -1.0       # mono
    tb = ed.tables._replace(hp_obs=_t(obs))
    act = [(rng.random(n) > 0.1).astype(np.float32)
           for n in bh.family_sizes(tb)]
    return (camR, camt, joints, seg_len, motR, mott), tb, act


SIG = (0.5, 20.0, 20.0, 2.795483, 1.0, 1.0)


@pytest.mark.parametrize("huber", [True, False])
def test_human_edges_ref_matches_jax(huber):
    rng = np.random.default_rng(16)
    state, tb, act = _human_problem(rng)
    hs, bs_, rhos, chis, zh = _jax_human(state, tb, act, SIG, huber)
    args = tuple(_t(x) for x in state)
    col = bh.human_edge_blocks(*args, tb, [_t(a) for a in act], CAM, SIG,
                               huber)
    cost = bh.human_edge_cost(*args, tb, CAM, SIG, huber)
    sizes = [h.size for h in hs] + [b.size for b in bs_]
    parts = col.split(sizes)
    assert col.shape[0] == bh.n_values(tb) == sum(sizes)
    for got, want, name in zip(parts, hs + bs_,
                               ("H proj", "H rigid", "H motion", "b proj",
                                "b rigid", "b motion")):
        _close(got, want, 1e-4, name)
    n = [len(r) for r in rhos]
    for got, want, name in zip(cost.rho.split(n), rhos, ("proj", "rigid",
                                                         "motion")):
        _close(got, want, 1e-4, "rho " + name)
    for got, want, name in zip(cost.chi2.split(n), chis, ("proj", "rigid",
                                                          "motion")):
        _close(got, want, 1e-4, "chi2 " + name)
    _close(cost.zh, zh, 1e-5, "zh")


def test_human_edges_ref_takes_an_empty_family():
    """One pose a trajectory: no motion edge."""
    rng = np.random.default_rng(17)
    state, tb, act = _human_problem(rng, T=2, L=1)
    assert bh.family_sizes(tb)[2] == 0
    args = tuple(_t(x) for x in state)
    col = bh.human_edge_blocks(*args, tb, [_t(a) for a in act], CAM, SIG,
                               True)
    cost = bh.human_edge_cost(*args, tb, CAM, SIG, True)
    Eh, Er, _ = bh.family_sizes(tb)
    assert col.shape == (90 * Eh + 56 * Er,)
    assert cost.rho.shape == (Eh + Er,) and cost.zh.shape == (Eh,)
    assert float(lc.lm_cost_ref(cost.rho[Eh + Er:], torch.zeros(0))) == 0.0


@pytest.mark.parametrize("n", [1, 1000, 1024, 5000, 16384])
def test_lm_cost_ref_matches_jax_sum(n):
    rng = np.random.default_rng(n)
    rho = rng.exponential(3.0, n).astype(np.float32)
    act = (rng.random(n) > 0.2).astype(np.float32)
    want = float(jnp.sum(jnp.where(jnp.isfinite(rho), rho, 1e30) * act))
    got = lc.lm_cost_ref(_t(rho), _t(act))
    assert got.dim() == 0 and got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-5 * abs(want)


def test_lm_cost_ref_sums_in_the_stated_order():
    """2049 terms: partial 0 adds terms 0, 1024, 2048 in sequence, partial
    1 terms 1 and 1025; then partial j + partial j + 512, ..., 1.  With 1
    at term 0, 2^24 at 1024 and 1 at 2048, partial 0 rounds each 1 away
    (2^24 + 1 ties to 2^24), and so does adding partial 1 (0.75): the sum
    is 2^24, where the exact sum rounds to 2^24 + 2."""
    n = 2049
    rho = np.zeros(n, np.float32)
    rho[0], rho[1024], rho[2048] = 1.0, 2.0 ** 24, 1.0
    rho[1], rho[1025] = 0.5, 0.25
    act = np.ones(n, np.float32)
    part = np.zeros(1024, np.float32)
    for i in range(n):
        part[i % 1024] = np.float32(part[i % 1024] + rho[i])
    half = 512
    while half:
        part = (part[:half] + part[half:2 * half]).astype(np.float32)
        half //= 2
    got = float(lc.lm_cost_ref(_t(rho), _t(act)))
    assert got == float(part[0]) == 2.0 ** 24
    assert float(np.float32(rho.astype(np.float64).sum())) == 2.0 ** 24 + 2


def test_lm_cost_ref_pads_with_exact_zeros_and_guards_non_finite():
    rho = np.array([3.0, np.inf, np.nan, -np.inf, 2.0], np.float32)
    act = np.array([1.0, 0.0, 1.0, 0.0, 1.0], np.float32)
    # inactive non-finite edges add 0 (1e30 x 0); the active NaN adds 1e30
    got = float(lc.lm_cost_ref(_t(rho), _t(act)))
    assert got == float(np.float32(np.float32(5.0) + np.float32(1e30)))
    # padding 5 terms to 1024 adds exact zeros: the same as a sum over the
    # 5 partials alone
    vals = np.float32([0.1, 0.2, 0.3, 0.4, 0.5])
    want = np.float32(np.float32(np.float32(vals[0] + vals[4]) + vals[2])
                      + np.float32(vals[1] + vals[3]))
    assert float(lc.lm_cost_ref(_t(vals), torch.ones(5))) == float(want)
    assert float(lc.lm_cost_ref(torch.zeros(0), torch.zeros(0))) == 0.0


def _counted(monkeypatch, module, names, calls=None):
    """Count the calls of module's functions `names` into calls."""
    calls = {} if calls is None else calls
    calls.update({name: 0 for name in names})
    for name in names:
        fn = getattr(module, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)
    return calls


def test_local_bundle_adjust_goes_through_the_kernels(monkeypatch):
    """A solve: 15 Gauss-Newton steps (rows, landmark reduce and
    back-substitution each), 17 costs (edges in cost-sum mode) and 2
    chi-square passes (cost mode): static_edge_blocks 34 launches in
    all."""
    from test_torch_mapping import _ba_problem
    calls = _counted(monkeypatch, tlba,
                     ("static_edge_blocks", "static_edge_cost",
                      "static_edge_cost_sum", "landmark_reduce",
                      "landmark_backsub"))
    arrays, intr = _ba_problem(False)
    tlba.local_bundle_adjust(*(_t(a) for a in arrays), *intr)
    assert calls == {"static_edge_blocks": 15, "static_edge_cost": 2,
                     "static_edge_cost_sum": 17, "landmark_reduce": 15,
                     "landmark_backsub": 15}


def test_human_bundle_adjust_goes_through_the_kernels(monkeypatch):
    """A solve: 15 steps, 17 costs (the static family's and the three
    human families' in the kernels' cost-sum modes), 2 passes: 34
    static_edge_blocks and 34 human_edge_blocks launches."""
    from test_torch_human import _ba_case, _run_port
    calls = _counted(monkeypatch, thba,
                     ("static_edge_blocks", "static_edge_cost",
                      "static_edge_cost_sum", "human_edge_blocks",
                      "human_edge_cost", "human_edge_cost_sum"))
    _counted(monkeypatch, tlba, ("landmark_reduce", "landmark_backsub"),
             calls)
    _run_port(_ba_case("clean")[0])
    assert calls == {"static_edge_blocks": 15, "static_edge_cost": 2,
                     "static_edge_cost_sum": 17, "human_edge_blocks": 15,
                     "human_edge_cost": 2, "human_edge_cost_sum": 17,
                     "landmark_reduce": 15, "landmark_backsub": 15}


def test_cuda_wrappers_raise_on_cpu_tensors():
    rng = np.random.default_rng(18)
    R, t, pts, e_cam, e_pt, obs, info, active = (
        _t(a) for a in _static_problem(rng, E=10))
    with pytest.raises(ValueError):
        bs.static_edges_cuda(R, t, pts, e_cam, e_pt, obs, info, active, CAM,
                             1.0, True, False)
    pt_sums, wagg, valid, dx_c = (_t(a) for a in _landmark_problem(rng))
    P = pt_sums.shape[0]
    with pytest.raises(ValueError):
        bp.landmark_reduce_cuda(pt_sums, wagg.reshape(P, -1), valid,
                                torch.tensor(1e-6))
    with pytest.raises(ValueError):
        bp.landmark_backsub_cuda(torch.zeros(P, 3, 3), pt_sums,
                                 wagg.reshape(P, -1), dx_c, valid)
    state, tb, act = _human_problem(rng)
    with pytest.raises(ValueError):
        bh.human_edges_cuda(*(_t(x) for x in state), tb,
                            [_t(a) for a in act], CAM, SIG, True, False)


@pytest.mark.parametrize("k", [1, 6, 15])
def test_build_pyramid_mask_erode_matches_jax(k):
    rng = np.random.default_rng(k)
    img = rng.uniform(0, 255, (90, 120)).astype(np.float32)
    mask = np.ones((90, 120), np.float32)
    mask[30:50, 40:70] = 0.0
    mask[rng.random(mask.shape) < 0.002] = 0.0
    want = jpyr.build_pyramid(jnp.asarray(img), jnp.asarray(mask), 4, 1.2,
                              mask_erode=k)
    got = tpyr.build_pyramid(_t(img), _t(mask), 4, 1.2, mask_erode=k)
    for lvl in range(4):
        np.testing.assert_array_equal(got.masks[lvl].numpy(),
                                      np.asarray(want.masks[lvl]))
    if k != 10:
        ten = tpyr.build_pyramid(_t(img), _t(mask), 4, 1.2)
        assert not torch.equal(ten.masks[0], got.masks[0])


def test_stack_pyramid_is_exported_where_airdos_tpu_exports_it():
    from airdos_tpu.matching import stereo as jstereo
    from airdos_tpu_torch.matching import stack_pyramid as from_package
    from airdos_tpu_torch.matching.stereo import stack_pyramid
    from airdos_tpu_torch.ops.stereo_sad import stack_pyramid as defined
    assert stack_pyramid is defined and from_package is defined
    levels = [np.arange(12, dtype=np.float32).reshape(3, 4),
              np.ones((2, 3), np.float32)]
    np.testing.assert_array_equal(
        stack_pyramid([_t(x) for x in levels]).numpy(),
        np.asarray(jstereo.stack_pyramid([jnp.asarray(x) for x in levels])))
