"""The loop correction's two solvers on their kernels' plain versions, on
the CPU: the global BA's CG half-steps (csrc/ba_global.cu,
ops/ba_global.py) and the essential graph's Sim(3) edge system
(csrc/sim3_edges.cu, ops/pose_graph_kernels.py).  Stated tolerances:

- fixed_sum / fixed_dot against a scalar float32 walk of the kernels'
  lanes and tree: bit-equal.  camera_sums_ref against a numpy loop in
  schur_camera's walk order, at segment lengths 0 to 900: bit-equal.
- schur_point + schur_camera against the composition they replaced (the
  einsums, segment sums and torch.sum dot products of
  solvers/global_ba.py before them, kept here as ``_old_cg``) on a
  seeded reduced system (C 12, P 300, E 2,000, a fixed camera, invalid
  edges and points): in float64 one iteration within 1e-12 and 48 within
  1e-9 of the largest entry (the same algebra in another order); in
  float32 one iteration within 1e-5 and 48 within 1e-3 (CG carries each
  iteration's rounding on).
- raw modes: the sums, which matvec by Hpp^-1 and cg_update turn into
  the non-raw results bit for bit; the halves prepared once a step
  (point_half, camera_half) give the bits of halves prepared anew each
  call, and the card's prepared launchers raise on a CPU tensor, a wrong
  dtype or shape, or an x off 8 bytes.
  Rows outside ``base`` (NaN here) are read by no segment.
- global_bundle_adjust through them against airdos_tpu's on the corridor
  at C 12, P 300: cameras within 1e-4, points seen twice within 1e-3 m,
  edge inliers equal (tests/test_torch_loop_solvers.py's limits); 48
  launches of each half a step and 4 segment sums; two CPU runs
  bit-equal.  The mesh path (raw mode, 4 ranks on the CPU) against the
  single-device solve: t within 2e-3 m, points' median error < 0.05 m
  (tests/test_sharded_ba.py's), and every rank's raw launches counted.
- the kernel's forward-mode edge system, emulated on the CPU
  (tests/torch_sim3_dual.py), against airdos_tpu's jax.jacfwd: residual
  within 1e-5, Jacobians within 1e-4 where the scale is fixed (the
  stereo essential graph, at generic angles, at theta ~ 0 and theta ~
  pi); with scales away from 1 (Sim(3)'s generic and small-angle V,
  whose closed form cancels in float32) within 1e-4 of the largest entry
  in float64 against the port's reverse mode, where both are the same
  derivative.
- sim3_edges' plain version (GN and cost mode) against airdos_tpu's
  jacfwd edge system and cost on the same edges: J^T J and J^T e within
  1e-4 of the largest entry, the cost within 1e-5 relative.
- optimize_essential_graph (K 16, E 40) against airdos_tpu's: poses
  within 1e-4; one sim3_edges call a step in GN mode and 1 + 20 in cost
  mode; two CPU runs bit-equal.
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
from airdos_tpu.solvers.global_ba import global_bundle_adjust as jax_gba
from airdos_tpu_torch.ops import ba_global as bg
from airdos_tpu_torch.ops import pose_graph_kernels as pgk
from airdos_tpu_torch.ops.segment_kernels import make_segments, segment_sum
from airdos_tpu_torch.parallel import sharded_ba as tsb
from airdos_tpu_torch.solvers import global_ba as tgba
from airdos_tpu_torch.solvers import pose_graph as tpg

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_sim3_dual as dual  # noqa: E402
from test_torch_loop_solvers import _corridor  # noqa: E402
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------ fixed order

def _lane_sum(q):
    """The kernels' order, one float32 operation at a time."""
    q = np.asarray(q, np.float32)
    lanes = [np.float32(0.0)] * bg.LANES
    for c, v in enumerate(q):
        lanes[c % bg.LANES] = np.float32(lanes[c % bg.LANES] + v)
    off = bg.LANES // 2
    while off:
        lanes = [np.float32(lanes[j] + lanes[j + off]) for j in range(off)]
        off //= 2
    return lanes[0]


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 3001])
def test_fixed_sum_is_the_kernels_lane_order(n):
    rng = np.random.default_rng(n)
    q = (rng.standard_normal(n) * 10.0 ** rng.integers(-4, 4, n)
         ).astype(np.float32)
    got = bg.fixed_sum(_t(q))
    assert got.shape == (1,)
    assert got.numpy()[0] == _lane_sum(q)
    a = rng.standard_normal((n, 6)).astype(np.float32)
    b = rng.standard_normal((n, 6)).astype(np.float32)
    rows = [np.float32(0.0)] * n
    for c in range(n):
        acc = np.float32(a[c, 0] * b[c, 0])
        for k in range(1, 6):
            acc = np.float32(acc + np.float32(a[c, k] * b[c, k]))
        rows[c] = acc
    assert bg.fixed_dot(_t(a), _t(b)).numpy()[0] == _lane_sum(rows)


def _numpy_walk_sums(y, offsets):
    """csrc/ba_global.cu's camera order, one float32 operation at a time:
    each segment's rows added in walk order from 0."""
    y = np.asarray(y, np.float32)
    out = np.zeros((len(offsets) - 1, y.shape[1]), np.float32)
    for s in range(len(offsets) - 1):
        for i in range(offsets[s], offsets[s + 1]):
            out[s] = (out[s] + y[i]).astype(np.float32)
    return out


@pytest.mark.parametrize("length", [0, 1, 31, 32, 33, 300, 900])
def test_camera_sums_are_the_kernels_walk_order(length):
    """camera_sums_ref against a numpy loop in schur_camera's order (each
    camera's rows in walk order, as its warp's six lanes add them across
    32-row rounds and 320-row buffers), bit for bit: a segment of `length`
    rows between segments of 0, 5 and 70 rows, rows of mixed magnitudes
    and signs, and rows past the last segment (none of its)."""
    rng = np.random.default_rng(length)
    sizes = [5, length, 0, 70]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    E = int(offsets[-1]) + 7
    P = 50
    w = (rng.standard_normal((E, 18)) * 10.0 ** rng.integers(-3, 3, (E, 1))
         ).astype(np.float32)
    pt = rng.integers(0, P, E).astype(np.int32)
    z = rng.standard_normal((P, 3)).astype(np.float32)
    key = np.repeat(np.arange(len(sizes) + 1), sizes + [7])
    walk = bg.Walk(rows=torch.arange(E), other=_t(pt), key=_t(key),
                   offsets=_t(offsets), n=len(sizes))
    got = bg.camera_sums_ref(_t(w), walk, _t(z))
    W = w.reshape(E, 6, 3)
    zg = z[pt]
    y = W[:, :, 0] * zg[:, 0:1]
    for m in range(1, 3):
        y = (y + W[:, :, m] * zg[:, m:m + 1]).astype(np.float32)
    want = _numpy_walk_sums(y, offsets)
    assert got.dtype == torch.float32 and got.shape == (len(sizes), 6)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    assert not got[2].any()


# ------------------------------------------------------ the CG half-steps

def _reduced_system(dtype, C=12, P=300, E=2000, seed=0):
    """A seeded reduced camera system as one Gauss-Newton step hands the
    CG: Wcp [E, 6, 3], Hpp^-1 [P, 3, 3] (zero for invalid points), Hcc_d
    and D^-1 [C, 6, 6], b_red [C, 6], the segment indices (a tenth of the
    edges outside base), camera 0 fixed.  Hcc_d dominates W Hpp^-1 W^T,
    so S is positive definite."""
    rng = np.random.default_rng(seed)
    e_cam = rng.integers(0, C, E)
    e_pt = rng.integers(0, P, E)
    point_valid = rng.random(P) > 0.05
    base = (rng.random(E) > 0.1) & point_valid[e_pt]
    wcp = rng.standard_normal((E, 6, 3))
    A = rng.standard_normal((P, 3, 3)) * 0.05
    hpp_inv = (A @ A.transpose(0, 2, 1) + 0.02 * np.eye(3)) * \
        point_valid[:, None, None]
    B = rng.standard_normal((C, 6, 6))
    hcc_d = B @ B.transpose(0, 2, 1) + 400.0 * np.eye(6)
    cam_free = np.ones(C)
    cam_free[0] = 0.0
    d_inv = np.linalg.inv(hcc_d)
    d_inv[0] = np.eye(6)
    b_red = rng.standard_normal((C, 6)) * cam_free[:, None]
    to = lambda a: _t(a).to(dtype)      # noqa: E731
    seg_c = make_segments(_t(e_cam), C, _t(base))
    seg_p = make_segments(_t(e_pt), P, _t(base))
    wcp_t = to(wcp)
    wcp_t[~_t(base)] = float("nan")     # never read: they join no segment
    return dict(wcp=wcp_t, hpp_inv=to(hpp_inv), hcc_d=to(hcc_d),
                d_inv=to(d_inv), cam_free=to(cam_free), b_red=to(b_red),
                seg_c=seg_c, seg_p=seg_p, e_cam=_t(e_cam), e_pt=_t(e_pt),
                base=_t(base))


def _old_cg(s, iters):
    """The CG of solvers/global_ba.py before the kernels (airdos_tpu's
    schur_matvec / precond / cg_body as einsums, segment sums and
    torch.sum dot products).  The rows outside base hold NaN here, which
    the old composition's einsums would spread: they are zeroed, as the
    BA's weights made them."""
    wcp = torch.where(s["base"][:, None, None], s["wcp"],
                      torch.zeros_like(s["wcp"]))
    cam_free = s["cam_free"][:, None]
    e_cam, e_pt = s["e_cam"], s["e_pt"]
    hpp_inv, hcc_d, d_inv = s["hpp_inv"], s["hcc_d"], s["d_inv"]

    def schur_matvec(x):
        x = x * cam_free
        y = torch.einsum("ekl,ek->el", wcp, x[e_cam])
        z = torch.einsum("plm,pm->pl", hpp_inv, segment_sum(y, s["seg_p"]))
        back = segment_sum(torch.einsum("ekl,el->ek", wcp, z[e_pt]),
                           s["seg_c"])
        Sx = torch.einsum("ckl,cl->ck", hcc_d, x) - back
        return Sx * cam_free + x * (1.0 - cam_free)

    def precond(r):
        return torch.einsum("ckl,cl->ck", d_inv, r)

    x = torch.zeros_like(s["b_red"])
    r = s["b_red"]
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    zero = torch.zeros_like(rz)
    for _ in range(iters):
        Ap = schur_matvec(p)
        pAp = torch.sum(p * Ap)
        alpha = torch.where(torch.abs(pAp) > 1e-20, rz / pAp, zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(torch.abs(rz) > 1e-20, rz_new / rz, zero)
        p = z + beta * p
        rz = rz_new
    return x, r, p, rz


def _new_cg(s, iters, raw=False):
    walk_c = bg.make_walk(s["seg_c"], s["e_pt"])
    walk_p = bg.make_walk(s["seg_p"], s["e_cam"])
    w_p, w_c = bg.walk_rows(s["wcp"], walk_p), bg.walk_rows(s["wcp"], walk_c)
    state = bg.cg_start(s["b_red"], s["d_inv"])
    for _ in range(iters):          # the halves prepared anew each call
        point = bg.point_half(w_p, walk_p, state.p, s["cam_free"],
                              s["hpp_inv"])
        camera = bg.camera_half(w_c, walk_c, state, s["hcc_d"], s["d_inv"],
                                s["cam_free"], s["hpp_inv"].shape[0])
        if raw:
            z = bg.matvec(s["hpp_inv"], point(raw=True))
            back = camera(z, raw=True)
            bg.cg_update(state, back, s["hcc_d"], s["d_inv"], s["cam_free"])
        else:
            camera(point())
    return state.x, state.r, state.p, state.rz[0]


@pytest.mark.parametrize("dtype,iters,tol", [
    (torch.float64, 1, 1e-12), (torch.float64, 48, 1e-9),
    (torch.float32, 1, 1e-5), (torch.float32, 48, 1e-3)])
def test_schur_halves_match_the_composition_they_replaced(dtype, iters, tol):
    s = _reduced_system(dtype)
    got = _new_cg(s, iters)
    want = _old_cg(s, iters)
    for name, g, w in zip(("x", "r", "p", "rz"), got, want):
        assert torch.isfinite(g).all(), name
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= tol * scale, (name, err, scale)
    # the fixed camera never moves
    assert not got[0][0].any()


def test_raw_modes_give_the_same_bits():
    s = _reduced_system(torch.float32)
    for iters in (1, 5):
        a = _new_cg(s, iters)
        b = _new_cg(s, iters, raw=True)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_prepared_halves_give_the_one_shot_bits():
    """point_half / camera_half, made once and called each iteration (the
    solver's loop), against the halves prepared anew for each call, raw
    and fused, over 5 iterations: bit-equal."""
    s = _reduced_system(torch.float32)
    walk_c = bg.make_walk(s["seg_c"], s["e_pt"])
    walk_p = bg.make_walk(s["seg_p"], s["e_cam"])
    w_p, w_c = bg.walk_rows(s["wcp"], walk_p), bg.walk_rows(s["wcp"], walk_c)
    for raw in (False, True):
        state = bg.cg_start(s["b_red"], s["d_inv"])
        point = bg.point_half(w_p, walk_p, state.p, s["cam_free"],
                              s["hpp_inv"])
        camera = bg.camera_half(w_c, walk_c, state, s["hcc_d"], s["d_inv"],
                                s["cam_free"], 300)
        for _ in range(5):
            if raw:
                z = bg.matvec(s["hpp_inv"], point(raw=True))
                bg.cg_update(state, camera(z, raw=True), s["hcc_d"],
                             s["d_inv"], s["cam_free"])
            else:
                assert camera(point()) is state
        want = _new_cg(s, 5, raw=raw)
        for a, b in zip((state.x, state.r, state.p, state.rz[0]), want):
            assert torch.equal(a, b)


def test_points_outside_every_segment_get_zero():
    s = _reduced_system(torch.float32)
    walk_p = bg.make_walk(s["seg_p"], s["e_cam"])
    w_p = bg.walk_rows(s["wcp"], walk_p)
    x = torch.randn(12, 6)
    z = bg.point_half(w_p, walk_p, x, s["cam_free"], s["hpp_inv"])(raw=True)
    kept = torch.zeros(300, dtype=torch.bool)
    kept[s["e_pt"][s["base"]]] = True
    moved = torch.zeros(300, dtype=torch.bool)  # an edge to a free camera
    moved[s["e_pt"][s["base"] & (s["e_cam"] != 0)]] = True
    assert torch.isfinite(z).all()
    assert not z[~kept].any() and z[moved].abs().sum(1).gt(0).all()


def test_global_ba_through_the_kernels_matches_jax(monkeypatch):
    rng = np.random.default_rng(12)
    args = _corridor(rng, C=12, P=300)
    arrays, scalars = args[:10], args[10:]
    kw = dict(iters1=2, iters2=3, cg_iters=48)
    want = jax_gba(*(jnp.asarray(a) for a in arrays), *scalars, **kw)
    calls = {"segment_sum": 0, "schur_point": 0, "schur_camera": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(tgba, "segment_sum",
                        counted("segment_sum", tgba.segment_sum))
    for name, half in (("schur_point", "point_half"),
                       ("schur_camera", "camera_half")):
        make = getattr(tgba, half)
        monkeypatch.setattr(tgba, half, lambda *a, name=name, make=make:
                            counted(name, make(*a)))
    got = tgba.global_bundle_adjust(*(_t(a) for a in arrays), *scalars, **kw)
    per_step = tgba.launches_per_step(48)
    assert calls == {k: n * 5 for k, n in per_step.items()}
    assert per_step == {"segment_sum": 4, "schur_point": 48,
                        "schur_camera": 48}
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=1e-4)
    np.testing.assert_array_equal(got.edge_inlier.numpy(),
                                  np.asarray(want.edge_inlier))
    twice = np.bincount(arrays[6], minlength=arrays[3].shape[0]) >= 2
    gap = np.linalg.norm(got.points.numpy() - np.asarray(want.points), axis=1)
    assert gap[twice].max() < 1e-3, gap[twice].max()
    again = tgba.global_bundle_adjust(*(_t(a) for a in arrays), *scalars,
                                      **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_sharded_global_ba_runs_the_raw_halves(monkeypatch):
    """The mesh path: every rank launches both halves in raw mode 32 times
    a step, and the update runs eagerly; within tests/test_sharded_ba.py's
    tolerances of the single-device solve, two runs bit-equal."""
    rng = np.random.default_rng(3)
    args = _corridor(rng, C=12, P=300)
    arrays, scalars = list(args[:10]), args[10:]
    n = 4
    pad = -len(arrays[5]) % n
    for i, fill in ((5, 0), (6, 0), (8, 1.0), (9, False)):
        arrays[i] = np.concatenate([arrays[i],
                                    np.full(pad, fill, arrays[i].dtype)])
    arrays[7] = np.concatenate([arrays[7], np.full((pad, 3), -1.0,
                                                   np.float32)])
    targs = [_t(a) for a in arrays]
    g1 = tgba.global_bundle_adjust(*targs, *scalars, iters1=3, iters2=4,
                                   cg_iters=32)
    raws = []

    def watch(make):
        def prepared(*args):
            half = make(*args)

            def call(*a, raw=False):
                raws.append(raw)
                return half(*a, raw=raw)
            return call
        return prepared

    monkeypatch.setattr(tgba, "point_half", watch(tgba.point_half))
    monkeypatch.setattr(tgba, "camera_half", watch(tgba.camera_half))
    mesh = tsb.make_mesh(n, "cpu")
    run = tsb.sharded_global_bundle_adjust(mesh, iters1=3, iters2=4,
                                           cg_iters=32)
    gs = run(*targs, *scalars)
    assert len(raws) == n * 2 * 32 * 7 and all(raws)
    assert all(torch.equal(a, b) for a, b in zip(gs, run(*targs, *scalars)))
    np.testing.assert_allclose(gs.t.numpy(), g1.t.numpy(), atol=2e-3)
    pts_err = np.linalg.norm(gs.points.numpy() - g1.points.numpy(), axis=1)
    assert np.median(pts_err) < 0.05


# ------------------------------------------------------ the Sim(3) edges

def _rot(w):
    return np.asarray(jax_so3_exp(jnp.asarray(w, jnp.float32)))


def _edges(regime, E=24, seed=0):
    """Per-edge inputs (Ri, ti, si, Rj, tj, sj, Rm, tm, sm) whose error
    S_m S_i S_j^-1 lies in `regime`: generic angles, theta ~ 0 (the
    measurement equal to the relative pose), theta ~ pi (a rotation of pi
    - delta about a generic axis), and with scales away from 1 (generic
    and small angles)."""
    rng = np.random.default_rng(seed)
    Ri = np.stack([_rot(rng.normal(0, 0.6, 3)) for _ in range(E)])
    Rj = np.stack([_rot(rng.normal(0, 0.6, 3)) for _ in range(E)])
    ti = rng.normal(0, 1, (E, 3)).astype(np.float32)
    tj = rng.normal(0, 1, (E, 3)).astype(np.float32)
    scaled = regime.startswith("scaled")
    si = rng.uniform(0.7, 1.4, E).astype(np.float32) if scaled \
        else np.ones(E, np.float32)
    sj = rng.uniform(0.7, 1.4, E).astype(np.float32) if scaled \
        else np.ones(E, np.float32)
    rel = np.einsum("eij,ekj->eik", Ri, Rj)          # Ri Rj^T
    if regime in ("generic", "scaled"):
        Rm = np.stack([_rot(rng.normal(0, 0.6, 3)) for _ in range(E)])
    elif regime in ("zero", "scaled_zero"):
        Rm = rel.transpose(0, 2, 1).copy()
    else:                                            # near pi
        axis = np.array([0.6, 0.48, 0.64])
        delta = rng.uniform(1e-3, 3e-2, E)
        Rm = np.stack([_rot(axis * (np.pi - d)) @ r.T
                       for d, r in zip(delta, rel)])
    tm = rng.normal(0, 1, (E, 3)).astype(np.float32)
    sm = rng.uniform(0.7, 1.4, E).astype(np.float32) if scaled \
        else np.ones(E, np.float32)
    return tuple(a.astype(np.float32) for a in
                 (Ri, ti, si, Rj, tj, sj, Rm, tm, sm))


def _jax_edge_system(per_edge):
    """airdos_tpu's edge_system (pose_graph.py:59): e [E, 7], J [E, 7,
    14] by jax.jacfwd under vmap."""
    zero7 = jnp.zeros(7, jnp.float32)

    def residual_fn(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
        def perturb(R, t, s, xi):
            return (jnp.matmul(jax_so3_exp(xi[3:6]), R, precision="highest"),
                    t + xi[:3], s * jnp.exp(xi[6]))
        return jpg._edge_residual(*perturb(Ri, ti, si, xi_i),
                                  *perturb(Rj, tj, sj, xi_j), Rm, tm, sm)

    jargs = tuple(jnp.asarray(a) for a in per_edge)
    ax = (None, None) + (0,) * 9
    e = jax.vmap(residual_fn, in_axes=ax)(zero7, zero7, *jargs)
    Ji = jax.vmap(jax.jacfwd(residual_fn, argnums=0), in_axes=ax)(
        zero7, zero7, *jargs)
    Jj = jax.vmap(jax.jacfwd(residual_fn, argnums=1), in_axes=ax)(
        zero7, zero7, *jargs)
    return np.asarray(e), np.concatenate([np.asarray(Ji), np.asarray(Jj)], 2)


def _vertex_form(per_edge):
    """The per-edge inputs as sim3_edges takes them: vertices 0..E-1 are
    the edges' i, E..2E-1 their j."""
    Ri, ti, si, Rj, tj, sj, Rm, tm, sm = per_edge
    E = len(ti)
    R = np.concatenate([Ri, Rj])
    t = np.concatenate([ti, tj])
    s = np.concatenate([si, sj])
    e_i = np.arange(E, dtype=np.int32)
    return R, t, s, e_i, e_i + E, Rm, tm, sm


@pytest.mark.parametrize("regime", ["generic", "zero", "pi"])
def test_forward_tangents_match_jacfwd(regime):
    """The kernel's forward mode (emulated) against jax.jacfwd where the
    scale is fixed, on each branch of so3_log."""
    per_edge = _edges(regime)
    e_j, J_j = _jax_edge_system(per_edge)
    R, t, s, e_i, e_jj, Rm, tm, sm = (_t(a) for a in _vertex_form(per_edge))
    e_d, J_d = dual.edge_system(R, t, s, e_i, e_jj, Rm, tm, sm)
    np.testing.assert_allclose(e_d.numpy(), e_j, atol=1e-5)
    np.testing.assert_allclose(J_d.numpy(), J_j, atol=1e-4)
    if regime == "zero":
        assert (np.abs(e_j[:, 3:6]).max(1) < 1e-6).all()
    if regime == "pi":
        assert (np.linalg.norm(e_j[:, 3:6], axis=1) > 3.1).all()


@pytest.mark.parametrize("regime", ["scaled", "scaled_zero", "pi", "zero"])
def test_forward_tangents_are_the_reverse_mode_derivative(regime):
    """In float64, where rounding does not hide the algebra: the emulated
    forward mode against the port's reverse mode (edge_jacobians), in
    Sim(3)'s generic and small-angle regimes too."""
    per_edge = [_t(a).double() for a in _edges(regime, seed=5)]
    vf = _vertex_form([a.numpy() for a in per_edge])
    R, t, s, e_i, e_jj, Rm, tm, sm = (_t(a) for a in vf)
    e_d, J_d = dual.edge_system(R, t, s, e_i, e_jj, Rm, tm, sm)
    e_r, Ji, Jj = pgk.edge_jacobians(*per_edge)
    J_r = torch.cat([Ji, Jj], 2)
    assert float((e_d - e_r).abs().max()) < 1e-10
    assert float((J_d - J_r).abs().max()) < 1e-4 * float(J_r.abs().max())


@pytest.mark.parametrize("regime", ["generic", "zero", "pi"])
def test_plain_sim3_edges_match_jax_edge_system(regime):
    per_edge = _edges(regime, seed=2)
    E = len(per_edge[1])
    e_j, J_j = _jax_edge_system(per_edge)
    w = np.ones(E, np.float32)
    w[3] = 0.0                                   # an invalid edge
    R, t, s, ei, ej, Rm, tm, sm = (_t(a) for a in _vertex_form(per_edge))
    col = pgk.sim3_edges(R, t, s, ei, ej, Rm, tm, sm, _t(w))
    assert col.shape == (E * pgk.ENTRIES, 1)
    H = np.einsum("erq,e,erp->eqp", J_j, w, J_j)
    b = -np.einsum("erq,e,er->eq", J_j, w, e_j)
    got_H = col[:E * 196, 0].reshape(E, 14, 14).numpy()
    got_b = col[E * 196:, 0].reshape(E, 14).numpy()
    assert np.abs(got_H - H).max() <= 1e-4 * np.abs(H).max()
    assert np.abs(got_b - b).max() <= 1e-4 * np.abs(b).max()
    assert not got_H[3].any() and not got_b[3].any()
    cost = pgk.sim3_edges(R, t, s, ei, ej, Rm, tm, sm, _t(w), cost=True)
    want = float(np.sum(np.sum(e_j * e_j, 1) * w))
    assert cost.dim() == 0
    assert abs(float(cost) - want) <= 1e-5 * want


def _graph_problem(K=16):
    """A drifted 16-keyframe chain with covisibility edges (i, i + 2) and
    (i, i + 3) from the estimates and one loop edge from the truth: 40
    edges."""
    gt_R, gt_t, est_R, est_t = [], [], [], []
    for k in range(K):
        R, t = jax_se3_exp(jnp.asarray([0.3 * k, 0, 0.05 * k, 0, 0.1 * k,
                                        0.01 * k], jnp.float32))
        gt_R.append(np.asarray(R))
        gt_t.append(np.asarray(t))
        dxi = np.concatenate([0.015 * k * np.ones(3),
                              0.003 * k * np.ones(3)]).astype(np.float32)
        dR, dt = jax_se3_exp(jnp.asarray(dxi))
        est_R.append(np.asarray(dR) @ gt_R[k])
        est_t.append(np.asarray(dR) @ gt_t[k] + np.asarray(dt))
    pairs = [(k, k + 1) for k in range(K - 1)] + \
        [(k, k + 2) for k in range(K - 2)] + [(k, k + 3) for k in range(10)]
    e_i, e_j, Rm, tm = [], [], [], []
    for (a, b), (Rs, ts) in zip(pairs + [(K - 1, 0)],
                                [(est_R, est_t)] * len(pairs) +
                                [(gt_R, gt_t)]):
        Rrel = Rs[b] @ Rs[a].T
        e_i.append(a)
        e_j.append(b)
        Rm.append(Rrel)
        tm.append(ts[b] - Rrel @ ts[a])
    fixed = np.zeros(K, bool)
    fixed[0] = True
    E = len(e_i)
    assert E == 40
    return (np.stack(est_R).astype(np.float32),
            np.stack(est_t).astype(np.float32), np.ones(K, np.float32),
            fixed, np.asarray(e_i, np.int32), np.asarray(e_j, np.int32),
            np.stack(Rm).astype(np.float32), np.stack(tm).astype(np.float32),
            np.ones(E, np.float32), np.ones(E, bool)), np.stack(gt_t)


def test_essential_graph_through_sim3_edges_matches_jax(monkeypatch):
    args, gt_t = _graph_problem()
    want = jpg.optimize_essential_graph(*(jnp.asarray(a) for a in args))
    modes = []
    real = tpg.sim3_edges
    monkeypatch.setattr(tpg, "sim3_edges",
                        lambda *a: modes.append(a[-1]) or real(*a))
    got = tpg.optimize_essential_graph(*(_t(a) for a in args))
    assert modes.count(False) == 20 and modes.count(True) == 21
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    err_before = np.linalg.norm(args[1][-1] - gt_t[-1])
    err_after = np.linalg.norm(got[1][-1].numpy() - gt_t[-1])
    assert err_after < 0.5 * err_before
    again = tpg.optimize_essential_graph(*(_t(a) for a in args))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_wrappers_raise_on_cpu_kernels():
    """The CUDA entry points take CUDA tensors only; CPU tensors go to the
    plain versions through the dispatchers."""
    s = _reduced_system(torch.float32)
    walk_p = bg.make_walk(s["seg_p"], s["e_cam"])
    walk_c = bg.make_walk(s["seg_c"], s["e_pt"])
    with pytest.raises(ValueError, match="CUDA"):
        bg.PointLaunch(bg.walk_rows(s["wcp"], walk_p), walk_p,
                       torch.zeros(12, 6), s["cam_free"], s["hpp_inv"])
    with pytest.raises(ValueError, match="CUDA"):
        bg.CameraLaunch(bg.walk_rows(s["wcp"], walk_c), walk_c, bg.cg_start(
            s["b_red"], s["d_inv"]), s["hcc_d"], s["d_inv"], s["cam_free"],
            300)
    per_edge = _edges("generic")
    with pytest.raises(ValueError):
        pgk.sim3_edges_cuda(*(_t(a) for a in _vertex_form(per_edge)),
                            torch.ones(24))


def _launch_inputs():
    s = _reduced_system(torch.float32)
    walk_c = bg.make_walk(s["seg_c"], s["e_pt"])
    walk_p = bg.make_walk(s["seg_p"], s["e_cam"])
    state = bg.cg_start(s["b_red"], s["d_inv"])
    point = dict(w_p=bg.walk_rows(s["wcp"], walk_p), walk_p=walk_p,
                 x=state.p, cam_free=s["cam_free"], hpp_inv=s["hpp_inv"])
    camera = dict(w_c=bg.walk_rows(s["wcp"], walk_c), walk_c=walk_c,
                  state=state, hcc_d=s["hcc_d"], d_inv=s["d_inv"],
                  cam_free=s["cam_free"], n_points=300)
    return point, camera


@pytest.mark.parametrize("half,name,bad", [
    ("point", None, None), ("point", "x", "dtype"),
    ("point", "hpp_inv", "shape"), ("point", "cam_free", "shape"),
    ("point", "x", "align"),
    ("camera", None, None), ("camera", "hcc_d", "dtype"),
    ("camera", "d_inv", "shape"), ("camera", "state", "shape")])
def test_prepared_launchers_raise(half, name, bad):
    """PointLaunch and CameraLaunch (what point_half / camera_half make on
    CUDA tensors) check every tensor once, when made: a CPU tensor, a
    wrong dtype, a wrong shape or an x that does not start on 8 bytes (the
    point kernel's float2 loads) raises ValueError, and nothing falls back
    to the plain version."""
    point, camera = _launch_inputs()
    args = point if half == "point" else camera
    if name == "state":
        st = args["state"]
        args["state"] = st._replace(part=st.part[0])       # [C], not [2, C]
    elif bad == "dtype":
        args[name] = args[name].double()
    elif bad == "shape":
        args[name] = args[name][:-1]
    elif bad == "align":
        x = args[name]
        args[name] = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(
            x.shape)                    # contiguous, 4 bytes off
    cls = bg.PointLaunch if half == "point" else bg.CameraLaunch
    match = "8 bytes" if bad == "align" else \
        {"state": "part"}.get(name, name) or "CUDA"
    with pytest.raises(ValueError, match=match):
        cls(**args)


def test_system_gap_measures_each_edge_in_its_units():
    """chip_smoke's yardstick for sim3_edges: on the map-scale chain (1000
    keyframes 0.25 m apart, drifted, one loop edge; the residuals of the
    odometry edges are float32 noise 250 m from the origin) the plain
    version in float32 lies within each edge's tolerance of itself in
    float64, where the gap over the largest J^T e entry is larger than
    SYSTEM_RTOL; a J^T e entry of an odometry edge 200 m out moved by
    1e-5 of sqrt(its J^T J diagonal) times its translation scale is
    seen."""
    C = 1000
    ctr = np.stack([0.01 * np.arange(C), np.zeros(C), 0.25 * np.arange(C)],
                   1)
    ctr_n = ctr + np.linspace(0, 1, C)[:, None] * np.array([0.2, 0.1, 0.15])
    yaw = 0.1 * np.arange(C) / C
    R = np.zeros((C, 3, 3))
    R[:, 0, 0] = R[:, 2, 2] = np.cos(yaw)
    R[:, 0, 2], R[:, 2, 0] = np.sin(yaw), -np.sin(yaw)
    R[:, 1, 1] = 1.0
    t = -np.einsum("cij,cj->ci", R, ctr_n)
    ei = np.concatenate([np.arange(C - 1), [C - 1]]).astype(np.int32)
    ej = np.concatenate([np.arange(1, C), [0]]).astype(np.int32)
    Rs = np.concatenate([R[1:] @ R[:-1].transpose(0, 2, 1), np.eye(3)[None]])
    ts = np.concatenate([t[1:] - np.einsum("eij,ej->ei", Rs[:-1], t[:-1]),
                         (ctr[C - 1] - ctr[0])[None]])
    args = [_t(a.astype(np.float32)) for a in (R, t)] + [torch.ones(C)] + \
        [_t(ei), _t(ej)] + [_t(a.astype(np.float32)) for a in (Rs, ts)] + \
        [torch.ones(C), torch.ones(C)]
    args64 = [a.double() if a.is_floating_point() else a for a in args]
    got = pgk.sim3_edges(*args).double()
    want = pgk.sim3_edges(*args64)
    gap = pgk.system_gap(got, want, *args64)
    assert max(gap) < 1.0, gap
    b, bw = got[C * 196:], want[C * 196:]
    assert float((b - bw).abs().max() / bw.abs().max()) > pgk.SYSTEM_RTOL
    moved = got.clone()
    k = 800
    unit = float(torch.sqrt(want[k * 196:(k + 1) * 196].reshape(14, 14)
                            .diagonal().max()))
    unit *= float(torch.linalg.norm(args64[1][k]) + torch.linalg.norm(
        args64[1][k + 1]) + torch.linalg.norm(args64[6][k]))
    moved[C * 196 + k * 14 + 3] += 1e-5 * unit
    assert pgk.system_gap(moved, want, *args64)[1] > 1.0


def test_held_to_float64_where_float32_cancels():
    """pose_graph_kernels.held, chip_smoke's test of sim3_edges' system:
    on edges whose residual rotation is ~0.003-0.02 rad (Sim(3)'s V in its
    generic regime, whose closed forms cancel in float32) the plain
    version in float32 lies farther than its J^T J tolerance from
    float64; the kernel's forward mode (emulated) holds, and a column with
    one J^T J entry 1% off does not."""
    from airdos_tpu_torch.solvers.human_ba import scatter_values
    rng = np.random.default_rng(7)
    K = E = 300
    R = np.stack([_rot(rng.normal(0, 0.4, 3)) for _ in range(K)])
    t = rng.normal(0, 2, (K, 3)).astype(np.float32)
    e_i = rng.integers(0, K, E).astype(np.int32)
    e_j = ((e_i + rng.integers(1, K, E)) % K).astype(np.int32)
    rel = np.einsum("eij,ekj->eik", R[e_j], R[e_i])
    Rm = np.stack([_rot(rng.normal(0, 0.01, 3)) @ r for r in rel])
    tm = rng.normal(0, 1, (E, 3)).astype(np.float32)
    args = [_t(R), _t(t), torch.ones(K), _t(e_i), _t(e_j),
            _t(Rm.astype(np.float32)), _t(tm), torch.ones(E), torch.ones(E)]
    e, J = dual.edge_system(*args[:8])
    col = scatter_values(((J, args[8], e),))
    ok, mine, plain = pgk.held(col, *args)
    assert ok and max(plain) > pgk.SYSTEM_RTOL, (mine, plain)
    moved = col.clone()
    moved[5 * 196 + 3 * 14 + 3] *= 1.01
    assert not pgk.held(moved, *args)[0]
