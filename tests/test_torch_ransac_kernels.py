"""Relocalization's and the loop's geometry: the plain versions of
csrc/ransac.cu's EPnP and Horn modes and of csrc/sim3_opt.cu against
airdos_tpu (CPU), and the kernel sources compiled for the host against
the plain versions.  Inputs from tests/torch_ransac_cases.py (numpy
seeds).  Stated tolerances:

- EPnP hypotheses (H 256, n 200, noise-free observations): on the
  samples that both airdos_tpu and the plain version solve (every sample
  point reprojected within 2e-3 px) the poses within 5e-4 and the inlier
  counts equal.  That is 17 of the 256 minimal samples: EPnP's
  two case-1 starts with 6 Gauss-Newton steps rarely solve a 4-point
  sample, and what they reach elsewhere follows the eigensolver's free
  choices (the PCA axes' signs, the 4-dimensional null space's basis),
  which airdos_tpu's eigh and torch's make their own way.
- EPnP refine (n 200, 0.5 px noise) against airdos_tpu's refine
  (epnp.py:171-185) on the same best hypothesis: R and t within 1e-4,
  the inlier mask equal.
- Horn hypotheses and refine against airdos_tpu's horn_align and its
  mutual reprojection test, fix_scale True and False: poses within 5e-4
  and counts equal on distinct samples; the refine within 1e-4.
- optimize_sim3_ref against airdos_tpu's optimize_sim3, fix_scale True
  and False: R, t and s within 1e-4, the inlier mask equal.
- Degenerate samples (a repeated index): a NaN pose and no inliers in
  the plain versions.
- The kernel sources on the host (tests/torch_kernel_host.py, one thread
  a block): EPnP and Horn against the plain versions with the kernel's
  rule for the eigensolver's choices (canonical=True) in float64,
  hypotheses within 1e-5 where finite, counts equal, degenerate rows NaN
  with no inliers, refine within 1e-5; sim3_opt within 1e-5 of
  optimize_sim3_ref in float64 and the flags equal.
- The wrappers: CPU tensors take the plain versions and count no launch;
  a kernel wrapper raises ValueError on a CPU tensor.
"""
import ctypes
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airdos_tpu.solvers.align import horn_align as jax_horn
from airdos_tpu.solvers.epnp import epnp_pose as jax_epnp_pose
from airdos_tpu.solvers.sim3 import optimize_sim3 as jax_opt_sim3
import airdos_tpu_torch.ops.ransac_kernels as rk
import airdos_tpu_torch.ops.sim3_opt_kernels as sok
from airdos_tpu_torch.solvers import epnp as ep
from airdos_tpu_torch.solvers import sim3 as s3

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_kernel_host as kh  # noqa: E402
import torch_ransac_cases as trc  # noqa: E402
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)

CAM = (trc.FX, trc.FY, trc.CX, trc.CY)


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _project_err2(R, t, pw, uv):
    """[H, n] squared reprojection errors and depths (numpy, float64)."""
    xc = np.einsum("hij,nj->hni", R, pw) + t[:, None]
    z = xc[..., 2]
    e = (trc.FX * xc[..., 0] / z + trc.CX - uv[:, 0]) ** 2 + \
        (trc.FY * xc[..., 1] / z + trc.CY - uv[:, 1]) ** 2
    return e, z


def _sample_err(R, t, pw, uv, smp):
    """[H] largest reprojection error (px) of each sample's own points."""
    xc = np.einsum("hij,hnj->hni", R, pw[smp]) + t[:, None]
    e = (trc.FX * xc[..., 0] / xc[..., 2] + trc.CX - uv[smp][..., 0]) ** 2 \
        + (trc.FY * xc[..., 1] / xc[..., 2] + trc.CY - uv[smp][..., 1]) ** 2
    return np.sqrt(e).max(1)


@pytest.fixture(scope="module")
def host_ransac(tmp_path_factory):
    glue = """
extern "C" void host_epnp(const RansacParams* p) {
  for (long long b = 0; b < p->n_hyp; ++b) { blockIdx.x = b; epnp_kernel(*p); }
}
extern "C" void host_horn(const RansacParams* p) {
  for (long long b = 0; b < p->n_hyp; ++b) { blockIdx.x = b; horn_kernel(*p); }
}
template <int N>
int eigh_on_a_lane(const double* a, double* v, double* w) {
  static double A[N][N], V[N][N], W[N], rot[2][N / 2];
  for (int i = 0; i < N * N; ++i) A[i / N][i % N] = a[i];
  const int sweeps = small::warp_jacobi_eigh<N>(A, V, W, rot, 0);
  for (int i = 0; i < N * N; ++i) v[i] = V[i / N][i % N];
  for (int i = 0; i < N; ++i) w[i] = W[i];
  return sweeps;
}
extern "C" int host_eigh12(const double* a, double* v, double* w) {
  return eigh_on_a_lane<12>(a, v, w);
}
extern "C" int host_eigh4(const double* a, double* v, double* w) {
  return eigh_on_a_lane<4>(a, v, w);
}
"""
    return kh.build("ransac.cu", glue, tmp_path_factory.mktemp("ransac"))


@pytest.fixture(scope="module")
def host_sim3_opt(tmp_path_factory):
    glue = """
extern "C" void host_sim3_opt(const Sim3OptParams* p) { sim3_opt_kernel(*p); }
"""
    return kh.build("sim3_opt.cu", glue, tmp_path_factory.mktemp("sim3opt"))


def _ptr(x):
    return 0 if x is None else x.data_ptr()


def _host_ransac(lib, horn, n, H, refine, fix, a, b, valid, g1, g2, smp,
                 Rb=None, tb=None, sb=None, ib=None):
    """One emulated launch of ransac.cu on CPU tensors: the kernel
    wrapper's outputs."""
    R, t = torch.empty(H, 3, 3), torch.empty(H, 3)
    s = torch.empty(H) if horn else None
    inl = torch.empty(H, n, dtype=torch.bool)
    cnt = torch.empty(H, dtype=torch.int64)
    kh.call(lib.host_horn if horn else lib.host_epnp, rk._PARAMS.pack(
        n, H, int(refine), int(fix), *(_ptr(x) for x in (
            a, b, valid, g1, g2, smp, Rb, tb, sb, ib, R, t, s, inl, cnt)),
        *CAM))
    return (R, t, s, inl, cnt) if horn else (R, t, inl, cnt)


# ------------------------------------------------------------------ EPnP

def test_epnp_hypotheses_plain_version_matches_jax_on_solved_samples():
    pw, uv, valid, gate, smp = trc.pnp_case(3, n=200, n_out=40, noise=0.0,
                                            H=256)
    Rj, tj = jax.vmap(lambda i: jax_epnp_pose(
        jnp.asarray(pw)[i], jnp.asarray(uv)[i], jnp.ones(4), *CAM))(
            jnp.asarray(smp))
    Rj, tj = np.asarray(Rj, np.float64), np.asarray(tj, np.float64)
    e2, z = _project_err2(Rj, tj, pw, uv)
    counts_j = ((e2 < gate) & (z > 0)).sum(1)
    Rt, tt, _, ct = ep.epnp_hypotheses_ref(*_t((pw, uv, valid, gate, smp)),
                                           *CAM)
    Rt, tt = Rt.double().numpy(), tt.double().numpy()
    solved = (_sample_err(Rj, tj, pw, uv, smp) < 2e-3) & \
        (_sample_err(Rt, tt, pw, uv, smp) < 2e-3)
    assert solved.sum() >= 10
    gap = np.maximum(np.abs(Rt - Rj).reshape(256, -1).max(1),
                     np.abs(tt - tj).max(1))
    assert gap[solved].max() < 5e-4
    np.testing.assert_array_equal(ct.numpy()[solved], counts_j[solved])


def test_epnp_refine_plain_version_matches_jax():
    pw, uv, valid, gate, smp = trc.pnp_case(4, n=200, n_out=40, H=64)
    args = _t((pw, uv, valid, gate, smp))
    Rs, ts, inls, counts = ep.epnp_hypotheses_ref(*args, *CAM)
    best = int(torch.argmax(counts))
    got = ep.epnp_refine_ref(*args[:4], Rs[best], ts[best], inls[best], *CAM)
    # airdos_tpu's refine (epnp.py:171-185) from the same hypothesis
    inl_b = inls[best].numpy()
    Rr, tr = jax_epnp_pose(jnp.asarray(pw), jnp.asarray(uv),
                           jnp.asarray(inl_b.astype(np.float32) + 1e-6),
                           *CAM)
    Rr, tr = np.asarray(Rr, np.float64), np.asarray(tr, np.float64)
    e2, z = _project_err2(Rr[None], tr[None], pw, uv)
    inl_r = valid & (e2[0] < gate) & (z[0] > 0)
    assert inl_r.sum() >= inl_b.sum()          # the refine is kept
    np.testing.assert_allclose(got[0].numpy(), Rr, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), tr, atol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), inl_r)
    assert int(got[3]) == int(inl_r.sum()) >= 155


def test_epnp_kernel_source_on_the_host_matches_plain_version(host_ransac):
    pw, uv, valid, gate, smp = trc.pnp_case(5, n=120, n_out=24, H=96,
                                            distinct=False)
    args = _t((pw, uv, valid, gate, smp))
    got = _host_ransac(host_ransac, False, 120, 96, False, True, args[0],
                       args[1], args[2], args[3], args[3], args[4])
    want = ep.epnp_hypotheses_ref(args[0].double(), args[1].double(),
                                  args[2], args[3].double(), args[4], *CAM,
                                  canonical=True)
    bad = rk.repeats(args[4].long())
    assert 0 < int(bad.sum()) < 96
    assert torch.isnan(got[0][bad]).all() and (got[3][bad] == 0).all()
    assert torch.isnan(want[0][bad]).all() and (want[3][bad] == 0).all()
    gap = (rk.pose_rows(got) - rk.pose_rows(want))[~bad].abs().amax(1)
    assert float(gap.max()) < 1e-5
    assert torch.equal(got[3], want[3])
    best = torch.argmax(got[3])
    ref_args = (args[0], args[1], args[2], args[3], got[0][best].contiguous(),
                got[1][best].contiguous(), got[2][best].contiguous())
    r = _host_ransac(host_ransac, False, 120, 1, True, True, *ref_args[:4],
                     ref_args[3], None, *ref_args[4:6], None, ref_args[6])
    w = ep.epnp_refine_ref(args[0].double(), args[1].double(), args[2],
                           args[3].double(), ref_args[4].double(),
                           ref_args[5].double(), ref_args[6], *CAM,
                           canonical=True)
    assert float((r[0][0] - w[0]).abs().max()) < 1e-5
    assert float((r[1][0] - w[1]).abs().max()) < 1e-5
    assert torch.equal(r[2][0], w[2]) and int(r[3][0]) == int(w[3])


def _mtm_cases():
    """EPnP's M^T M (float64, solvers/epnp.py's plain steps, canonical
    PCA axes): minimal samples (a 4-dimensional null space, its
    eigenvalues within ~1e-12 of each other), all n = 483 points at 0.5
    px, and a synthetic matrix of M^T M's scale with a null pair 1e-12
    apart and a near-repeated pair above it."""
    out = []
    pw, uv, _, _, smp = trc.pnp_case(13, n=483, n_out=0, noise=0.5, H=6)
    sets = [(pw[s], uv[s]) for s in smp] + [(pw, uv)]
    for P, U in sets:
        P = torch.from_numpy(P).double()[None]
        U = torch.from_numpy(U).double()[None]
        w = torch.ones(P.shape[:2], dtype=torch.float64)
        cps = ep._control_points(P, w, canonical=True)
        M = ep._build_M(ep._barycentric(P, cps), U, w, *CAM)
        out.append((f"n {P.shape[1]}", (M.transpose(-1, -2) @ M)[0]))
    rng = np.random.default_rng(14)
    Q, _ = np.linalg.qr(rng.standard_normal((12, 12)))
    lam = np.array([0.0, 1e-12, 3.0, 3.0 + 1e-9, 10, 40, 1e2, 3e2, 1e3, 4e3,
                    2e4, 1e5]) * 30.0
    out.append(("pairs", torch.from_numpy((Q * lam) @ Q.T)))
    return out


MTM = _mtm_cases()


@pytest.mark.parametrize("case", MTM, ids=[c[0] for c in MTM])
def test_round_robin_eigh_on_a_lane_matches_torch(host_ransac, case):
    """small_eig.cuh warp_jacobi_eigh<12> (the host build: one lane takes
    the warp's steps) converges within its sweep limit and matches
    torch.linalg.eigh in float64: eigenvalues within 1e-10 of the matrix's
    norm, A V = V diag(w) and V^T V = I within 1e-10, the four smallest
    eigenvectors' span (EPnP's null space) within 1e-8 of torch's."""
    _, A = case
    A = (A + A.T) / 2
    a = A.contiguous().clone()
    v, w = torch.empty(12, 12, dtype=torch.float64), torch.empty(
        12, dtype=torch.float64)
    sweeps = host_ransac.host_eigh12(ctypes.c_void_p(a.data_ptr()),
                                     ctypes.c_void_p(v.data_ptr()),
                                     ctypes.c_void_p(w.data_ptr()))
    assert 0 < sweeps < 50
    wt, vt = torch.linalg.eigh(A)
    norm = float(torch.linalg.matrix_norm(A, 2))
    assert torch.all(w[1:] >= w[:-1])
    assert float((w - wt).abs().max()) < 1e-10 * norm
    assert float((A @ v - v * w).abs().max()) < 1e-10 * norm
    assert float((v.T @ v - torch.eye(12, dtype=torch.float64)).abs().max()) \
        < 1e-10
    null, null_t = v[:, :4], vt[:, :4]
    assert float((null @ null.T - null_t @ null_t.T).abs().max()) < 1e-8


def test_round_robin_eigh_rules(host_ransac):
    """The rules it keeps from jacobi_eigh: a diagonal matrix takes no
    sweep, ties keep the lower column first, a non-finite matrix gives
    NaN; a rotation at an exact tie of tiny entries stays finite; and the
    4 x 4 solve (the canonical basis's) matches torch."""
    def eigh(fn, a):
        n = a.shape[0]
        a = a.double().contiguous().clone()
        v = torch.empty(n, n, dtype=torch.float64)
        w = torch.empty(n, dtype=torch.float64)
        sweeps = fn(ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(
            v.data_ptr()), ctypes.c_void_p(w.data_ptr()))
        return sweeps, v, w

    d = torch.tensor([3.0, 1.0, 2.0, 1.0, 5.0, 0.5, 2.0, 7.0, 1.0, 4.0,
                      6.0, 0.25], dtype=torch.float64)
    sweeps, v, w = eigh(host_ransac.host_eigh12, torch.diag(d))
    assert sweeps == 0
    assert w.tolist() == sorted(d.tolist())
    order = sorted(range(12), key=lambda i: (d[i], i))      # stable
    assert torch.equal(v, torch.eye(12, dtype=torch.float64)[:, order])
    bad = torch.eye(12, dtype=torch.float64)
    bad[3, 5] = bad[5, 3] = float("inf")
    _, v, w = eigh(host_ransac.host_eigh12, bad)
    assert torch.isnan(v).all() and torch.isnan(w).all()
    # a pair at an exact tie with an off-diagonal whose square underflows:
    # the rotation stays finite (45 degrees), the eigenvalues 1 -+ 1e-170
    tie = torch.diag(torch.tensor([1.0, 1.0, 2.0, 3.0], dtype=torch.float64))
    tie[0, 1] = tie[1, 0] = 1e-170
    _, v, w = eigh(host_ransac.host_eigh4, tie)
    assert torch.isfinite(v).all()
    assert float((w - torch.tensor([1.0, 1.0, 2.0, 3.0],
                                   dtype=torch.float64)).abs().max()) < 1e-15
    assert float((v.T @ v - torch.eye(4, dtype=torch.float64)).abs().max()) \
        < 1e-15
    rng = np.random.default_rng(15)
    B = torch.from_numpy(rng.standard_normal((4, 4)))
    B = B @ B.T
    sweeps, v, w = eigh(host_ransac.host_eigh4, B)
    wt, vt = torch.linalg.eigh(B)
    assert 0 < sweeps < 50
    assert float((w - wt).abs().max()) < 1e-12 * float(wt.abs().max())
    assert float(((v.T @ vt).abs() - torch.eye(4, dtype=torch.float64))
                 .abs().max()) < 1e-10


# ------------------------------------------------------------------ Horn

def _jax_reproj_counts(R, t, s, x1, x2, valid, g1, g2):
    """airdos_tpu's mutual reprojection test (sim3.py:41-61) of each
    hypothesis, in numpy."""
    def proj(p):
        z = np.where(np.abs(p[..., 2]) < 1e-9, 1e-9, p[..., 2])
        return np.stack([trc.FX * p[..., 0] / z + trc.CX,
                         trc.FY * p[..., 1] / z + trc.CY], -1)
    p1 = s[:, None, None] * np.einsum("hij,nj->hni", R, x2) + t[:, None]
    p2 = np.einsum("hji,hnj->hni", R, x1[None] - t[:, None]) / \
        s[:, None, None]
    e1 = ((proj(p1) - proj(x1)[None]) ** 2).sum(-1)
    e2 = ((proj(p2) - proj(x2)[None]) ** 2).sum(-1)
    return (valid & (e1 < g1) & (e2 < g2)).sum(1)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_horn_plain_versions_match_jax(fix_scale):
    x1, x2, valid, g1, g2, smp = trc.sim3_case(
        6, n=150, n_out=30, scale=1.0 if fix_scale else 1.3, H=64)
    args = _t((x1, x2, valid, g1, g2, smp))
    Rs, ts, ss, inls, counts = s3.sim3_hypotheses_ref(*args, *CAM, fix_scale)
    Rj, tj, sj = (np.asarray(a, np.float64) for a in jax_horn(
        jnp.asarray(x1)[smp], jnp.asarray(x2)[smp], fix_scale=fix_scale))
    np.testing.assert_allclose(Rs.numpy(), Rj, atol=5e-4)
    np.testing.assert_allclose(ts.numpy(), tj, atol=5e-4)
    np.testing.assert_allclose(ss.numpy(), sj, atol=5e-4)
    np.testing.assert_array_equal(
        counts.numpy(), _jax_reproj_counts(Rj, tj, sj, x1, x2, valid, g1, g2))
    best = int(torch.argmax(counts))
    got = s3.sim3_refine_ref(*args[:5], Rs[best], ts[best], ss[best],
                             inls[best], *CAM, fix_scale)
    w = inls[best].numpy().astype(np.float32) + 1e-6
    Rr, tr, sr = (np.asarray(a, np.float64) for a in jax_horn(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w),
        fix_scale=fix_scale))
    np.testing.assert_allclose(got[0].numpy(), Rr, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), tr, atol=1e-4)
    np.testing.assert_allclose(float(got[2]), sr, rtol=1e-4)
    assert int(got[4]) == int(_jax_reproj_counts(
        Rr[None], tr[None], np.atleast_1d(sr), x1, x2, valid, g1, g2)[0])


@pytest.mark.parametrize("fix_scale", [True, False])
def test_horn_kernel_source_on_the_host_matches_plain_version(host_ransac,
                                                              fix_scale):
    x1, x2, valid, g1, g2, smp = trc.sim3_case(
        7, n=60, n_out=12, scale=1.0 if fix_scale else 0.8, H=96,
        distinct=False)
    args = _t((x1, x2, valid, g1, g2, smp))
    got = _host_ransac(host_ransac, True, 60, 96, False, fix_scale, *args)
    d64 = [a.double() if a.is_floating_point() else a for a in args]
    want = s3.sim3_hypotheses_ref(*d64, *CAM, fix_scale)
    bad = rk.repeats(args[5].long())
    assert 0 < int(bad.sum()) < 96
    assert torch.isnan(got[0][bad]).all() and (got[4][bad] == 0).all()
    gap = (rk.pose_rows(got) - rk.pose_rows(want))[~bad].abs().amax(1)
    assert float(gap.max()) < 1e-5
    assert torch.equal(got[4], want[4])
    best = torch.argmax(got[4])
    rb = [got[i][best].contiguous() for i in range(4)]
    r = _host_ransac(host_ransac, True, 60, 1, True, fix_scale, *args[:5],
                     None, *rb)
    w = s3.sim3_refine_ref(*d64[:5], *(x.double() for x in rb[:3]), rb[3],
                           *CAM, fix_scale)
    for a, b in zip(r[:3], w[:3]):
        assert float((a[0] - b).abs().max()) < 1e-5
    assert torch.equal(r[3][0], w[3]) and int(r[4][0]) == int(w[4])


def test_degenerate_samples_give_nan_and_no_inliers():
    pw, uv, valid, gate, _ = trc.pnp_case(8, n=40, n_out=4, H=4)
    smp = torch.tensor([[0, 0, 1, 2], [5, 6, 7, 5], [3, 3, 3, 3],
                        [1, 2, 3, 4]], dtype=torch.int32)
    for canonical in (False, True):
        R, t, inl, counts = ep.epnp_hypotheses_ref(
            *_t((pw, uv, valid, gate)), smp, *CAM, canonical=canonical)
        assert torch.isnan(R[:3]).all() and torch.isnan(t[:3]).all()
        assert counts[:3].tolist() == [0, 0, 0] and not inl[:3].any()
        assert torch.isfinite(R[3]).all() and torch.isfinite(t[3]).all()
    x1, x2, valid, g1, g2, _ = trc.sim3_case(8, n=40, n_out=4, H=4)
    # three valid pairs off the outliers (sim3_case's pose, scale 1)
    truth = x2 @ trc.rot([0.05, 0.3, -0.1]).T + [0.5, -0.2, 0.8]
    sound = np.nonzero(valid & (np.linalg.norm(x1 - truth, axis=1) < 0.1))[0]
    smp3 = torch.tensor([[0, 0, 1], [4, 5, 4], sound[:3].tolist()],
                        dtype=torch.int32)
    R, t, s, inl, counts = s3.sim3_hypotheses_ref(
        *_t((x1, x2, valid, g1, g2)), smp3, *CAM, True)
    assert torch.isnan(R[:2]).all() and torch.isnan(s[:2]).all()
    assert counts[:2].tolist() == [0, 0] and int(counts[2]) > 20
    # a table with degenerate rows: the RANSAC's best is a sound one
    res = s3.sim3_ransac(*_t((x1, x2, valid)), smp3, *_t((g1, g2)), *CAM)
    assert int(res.best) == 2 and torch.isfinite(res.R).all()


# ------------------------------------------------------------ OptimizeSim3

@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_sim3_ref_matches_jax(fix_scale):
    case = trc.opt_case(9, n=300, scale=1.0 if fix_scale else 1.1)
    want = jax_opt_sim3(*(jnp.asarray(a) for a in case), *CAM, th2=10.0,
                        fix_scale=fix_scale)
    got = sok.optimize_sim3_ref(*_t(case), *CAM, th2=10.0,
                                fix_scale=fix_scale)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-4)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert int(got[4]) == int(want[4]) >= 270


@pytest.mark.parametrize("fix_scale", [True, False])
def test_sim3_opt_kernel_source_on_the_host_matches_plain_version(
        host_sim3_opt, fix_scale):
    case = _t(trc.opt_case(10, n=200, scale=1.0 if fix_scale else 1.1))
    out = torch.empty(13)
    inl = torch.empty(200, dtype=torch.bool)
    count = torch.empty((), dtype=torch.int64)
    kh.call(host_sim3_opt.host_sim3_opt, sok._PARAMS.pack(
        200, 10, int(fix_scale), *(_ptr(a) for a in case), _ptr(out),
        _ptr(inl), _ptr(count), *CAM, 10.0, 0.0))
    d64 = [a.double() if a.is_floating_point() else a for a in case]
    want = sok.optimize_sim3_ref(*d64, *CAM, th2=10.0, fix_scale=fix_scale)
    assert float((out[:9].view(3, 3) - want[0]).abs().max()) < 1e-5
    assert float((out[9:12] - want[1]).abs().max()) < 1e-5
    assert abs(float(out[12]) - float(want[2])) < 1e-5
    assert torch.equal(inl, want[3]) and int(count) == int(want[4])


# ------------------------------------------------------------- the wrappers

def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    def kernel(*args, **kwargs):
        raise AssertionError("a kernel wrapper ran on CPU tensors")

    for name in ("epnp_hypotheses_cuda", "epnp_refine_cuda",
                 "horn_hypotheses_cuda", "horn_refine_cuda"):
        monkeypatch.setattr(rk, name, kernel)
    monkeypatch.setattr(sok, "sim3_opt_cuda", kernel)
    n = (rk.launches(), sok.launches())
    pnp = _t(trc.pnp_case(11, n=60, n_out=10, H=32))
    res = ep.epnp_ransac(*pnp, *CAM)
    assert int(res.n_inliers) >= 45
    sim = _t(trc.sim3_case(11, n=60, n_out=10, H=32))
    res = s3.sim3_ransac(*sim[:3], sim[5], sim[3], sim[4], *CAM)
    assert int(res.n_inliers) >= 40
    opt = _t(trc.opt_case(11, n=60))
    assert int(s3.optimize_sim3(*opt, *CAM)[4]) >= 50
    assert (rk.launches(), sok.launches()) == n


def test_kernel_wrappers_raise_on_cpu_tensors():
    pw, uv, valid, gate, smp = _t(trc.pnp_case(12, n=30, n_out=3, H=8))
    with pytest.raises(ValueError):
        rk.epnp_hypotheses_cuda(pw, uv, valid, gate, smp, *CAM)
    with pytest.raises(ValueError):
        rk.epnp_refine_cuda(pw, uv, valid, gate, torch.eye(3),
                            torch.zeros(3), valid, *CAM)
    x1, x2, valid, g1, g2, smp = _t(trc.sim3_case(12, n=30, n_out=3, H=8))
    with pytest.raises(ValueError):
        rk.horn_hypotheses_cuda(x1, x2, valid, g1, g2, smp, *CAM, True)
    with pytest.raises(ValueError):
        rk.horn_refine_cuda(x1, x2, valid, g1, g2, torch.eye(3),
                            torch.zeros(3), torch.ones(()), valid, *CAM,
                            True)
    with pytest.raises(ValueError):
        sok.sim3_opt_cuda(*_t(trc.opt_case(12, n=30)), *CAM)
    assert rk.repeats(smp.long()).dtype == torch.bool
