"""The port's offline mapping pass against airdos_tpu (CPU).

Both packages get the same numpy inputs: the synthetic small world of
tests/test_system_e2e.py, and the map state of one airdos_tpu run carried
into the port with ``convert.map_from``.  Stated tolerances:

- local_bundle_adjust on tests/test_local_ba.py's problem, with and
  without outliers: R within 1e-4, t within 1e-4 m, edge_inlier equal;
  points observed by >= 2 inlier edges within 1e-3 m.  A point with one
  inlier edge is fixed by that edge alone (3 equations, 3 unknowns, the
  depth set by a ~13 px disparity): float32 rounding moves it by up to
  ~3 cm, and a float64 run of the port lies as far from airdos_tpu's
  float32 run there, so those points are held to 0.05 m; a point with no
  inlier edge is held only by damping and is not compared.
- the plain segment sum against jnp .at[].add: within 1e-6 relative.
- batched triangulate_pair against jax.vmap of the JAX function on
  keyframes of a small-world run: match indices equal on >= 99% of the
  slots either side matched; points within 2e-3 m where both are valid.
  The 3x3 normal equations of near-parallel rays are ill-conditioned: a
  float64 run of the port's formula lies ~7e-4 m from BOTH float32 results
  at the worst point, so 1e-4 m is below float32's floor there.
- batched triangulate_pair against the eager composition it replaced
  (tests/test_torch_triangulate_kernels.py) on the same keyframes: the
  search's argmin and distance equal, the rest within that file's
  tolerance.
- batched fuse_candidates against jax.vmap: match indices equal on >= 99%
  of the slots the write-back acts on (points not yet observed by the
  target) and on >= 95% of all matched slots.  A point seen at octave 1
  from its reference keyframe predicts its level from log(1.44) / log(1.2)
  = 2 exactly; XLA's CPU logf is 1 ulp low there (2 -> level 2), torch's
  is correctly rounded (2.0000002 -> level 3), so such slots can differ.
  They are all points the target already observes, which the write-back
  skips.
- one StaticLocalBA / Triangulator / Fuser call on identical map state:
  the same observations; keyframe poses within 1e-4; points within 1e-4 m,
  except: after the BA, a point at distance d from the keyframe within
  1e-4 m + 1e-5 d^2 (stereo depth uncertainty grows as d^2 / bf; float32
  rounding of the Schur solve moves far points along their rays by up to
  3.3e-6 d^2 between the packages, poses agree to 1e-6); newly
  triangulated points within 2e-3 m (as above).
- the offline System over 10 frames: the same state and branch per frame,
  keyframes within +-1, map points within 10%, ATE within 15% or 3 mm.
- two port runs: byte-identical TUM trajectory and SaveMap dumps.
"""
import copy
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airdos_tpu.geometry.se3 import se3_exp
from airdos_tpu.io.tum import ate_rmse
from airdos_tpu.matching.epipolar import triangulate_pair as jax_triangulate
from airdos_tpu.slam import ba_driver as jbd
from airdos_tpu.slam.local_mapping import LocalMapper as JaxLocalMapper
from airdos_tpu.slam.system import System as JaxSystem
from airdos_tpu.slam.tracking import Tracking as JaxTracking
from airdos_tpu.solvers.local_ba import local_bundle_adjust as jax_lba
from airdos_tpu_torch.convert import config_from, desc_to_tensor, map_from
from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
from airdos_tpu_torch.matching.epipolar import triangulate_pair
from airdos_tpu_torch.matching.fuse import fuse_candidates
from airdos_tpu_torch.ops.segment_kernels import (make_segments, segment_sum,
                                                  segment_sum_ref)
from airdos_tpu_torch.slam import ba_driver as tbd
from airdos_tpu_torch.slam.frame import FrontEnd
from airdos_tpu_torch.slam.local_mapping import LocalMapper
from airdos_tpu_torch.slam.system import System
from airdos_tpu_torch.slam.tracking import Tracking
from airdos_tpu_torch.solvers.local_ba import local_bundle_adjust

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_local_ba import make_problem  # noqa: E402
from test_system_e2e import small_config  # noqa: E402
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)

N_E2E = 10          # frames of the end-to-end comparison
SNAP_FRAME = 11     # the keyframe whose mapping step the drivers compare


@pytest.fixture(scope="module")
def frames():
    world = SyntheticStereoWorld(seed=0, n_points=200,
                                 cam=config_from(small_config()).camera)
    return [(d, Rwc, twc) for d, Rwc, twc in
            world.sequence(SNAP_FRAME + 1, dt=0.1, yaw_rate=0.008)]


@pytest.fixture(scope="module")
def jax_run(frames):
    """airdos_tpu's offline System over N_E2E frames (recorded), then on to
    SNAP_FRAME, whose keyframe is tracked but not yet mapped: the map
    state the driver comparisons start from."""
    slam = JaxSystem(small_config())
    per = []
    for data, _, _ in frames[:N_E2E]:
        slam.track_stereo(data)
        per.append((slam.tracking.state.name, slam.tracking.last_branch))
    _, _, t_est = slam.tracking.trajectory_tum()
    gt = np.asarray([twc for _, _, twc in frames[:N_E2E]])
    e2e = dict(per=per, n_kfs=slam.map.n_keyframes(),
               n_points=slam.map.n_points(),
               ate=ate_rmse(t_est, gt[:len(t_est)]),
               records=copy.deepcopy(slam.tracking.records),
               map=copy.deepcopy(slam.map))
    for data, _, _ in frames[N_E2E:SNAP_FRAME]:
        slam.track_stereo(data)
    slam.tracking.track(frames[SNAP_FRAME][0])      # no mapping step
    kf = slam.map.kfs[slam.tracking.last_kf_id]
    assert kf.frame_id == SNAP_FRAME
    return dict(e2e=e2e, slam=slam, kf_id=kf.id)


@pytest.fixture(scope="module")
def port_run(frames):
    slam = System(config_from(small_config()), device="cpu")
    per = []
    for data, _, _ in frames[:N_E2E]:
        slam.track_stereo(data)
        per.append((slam.tracking.state.name, slam.tracking.last_branch))
    _, _, t_est = slam.tracking.trajectory_tum()
    gt = np.asarray([twc for _, _, twc in frames[:N_E2E]])
    return dict(slam=slam, per=per, n_kfs=slam.map.n_keyframes(),
                n_points=slam.map.n_points(),
                ate=ate_rmse(t_est, gt[:len(t_est)]))


def _t(x):
    return torch.from_numpy(np.array(x))


# ----------------------------------------------------------- local BA
def _ba_problem(outliers: bool):
    rng = np.random.default_rng(0)
    fx, fy, cx, cy, bf, pts_gt, cams, e_cam, e_pt, e_obs = make_problem(
        rng, noise=0.2 if outliers else 0.1)
    C, P, E = len(cams), len(pts_gt), len(e_cam)
    cam_R = np.stack([c[0] for c in cams]).astype(np.float32)
    cam_t = np.stack([c[1] for c in cams]).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[:2] = True
    for c in range(2, C):
        xi = np.concatenate([rng.normal(0, 0.03, 3), rng.normal(0, 0.01, 3)])
        dR, dt = jax.device_get(se3_exp(jnp.asarray(xi.astype(np.float32))))
        cam_R[c] = dR @ cam_R[c]
        cam_t[c] = dR @ cam_t[c] + dt
    if outliers:
        out = rng.choice(E, E // 10, replace=False)
        e_obs[out, :2] += rng.uniform(15, 40, (len(out), 2)) * \
            rng.choice([-1, 1], (len(out), 2))
    pts = (pts_gt + rng.normal(0, 0.1, pts_gt.shape)).astype(np.float32)
    arrays = (cam_R, cam_t, fixed, pts, np.ones(P, bool), e_cam, e_pt, e_obs,
              np.ones(E, np.float32), np.ones(E, bool))
    return arrays, (fx, fy, cx, cy, bf)


@pytest.mark.parametrize("outliers", [False, True])
def test_local_bundle_adjust_matches_jax(outliers):
    arrays, intr = _ba_problem(outliers)
    ref = jax.device_get(jax_lba(*(jnp.asarray(a) for a in arrays), *intr))
    out = local_bundle_adjust(*(_t(a) for a in arrays), *intr)
    assert np.abs(out.R.numpy() - ref.R).max() < 1e-4
    assert np.abs(out.t.numpy() - ref.t).max() < 1e-4
    np.testing.assert_array_equal(out.edge_inlier.numpy(), ref.edge_inlier)
    e_pt = arrays[6]
    n_inl = np.bincount(e_pt[ref.edge_inlier], minlength=len(arrays[3]))
    err = np.linalg.norm(out.points.numpy() - ref.points, axis=1)
    assert err[n_inl >= 2].max() < 1e-3
    assert err[n_inl == 1].max(initial=0.0) < 0.05
    if outliers:
        assert not ref.edge_inlier.all()


def _check_segment_sum(n_dropped):
    """n_dropped rows lie outside `keep`, as the local BA's padding edges
    do: the JAX scatter-add keys them to segment 0, where their zero
    blocks add nothing; here they join no segment, every sum unchanged."""
    rng = np.random.default_rng(3)
    E, S, K = 4096, 300, 18
    key = rng.integers(0, S, E)
    vals = rng.normal(0, 1, (E, K)).astype(np.float32)
    keep = np.ones(E, bool)
    keep[E - n_dropped:] = False
    key[~keep] = 0
    vals[~keep] = 0.0
    want = np.asarray(jnp.zeros((S, K), jnp.float32).at[key].add(vals))
    tk, tv = torch.from_numpy(key), torch.from_numpy(vals)
    seg = make_segments(tk, S, torch.from_numpy(keep))
    got = segment_sum(tv, seg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, segment_sum(tv, make_segments(tk, S)))
    # the CSR index the kernel reads: each segment's kept rows, in row order
    perm, off = seg.perm.numpy(), seg.offsets.numpy()
    for s in (0, 7, S - 1):
        np.testing.assert_array_equal(perm[off[s]:off[s + 1]],
                                      np.nonzero((key == s) & keep)[0])
    assert off[-1] == keep.sum()
    assert torch.equal(segment_sum_ref(tv, seg.key, S), got)


def test_plain_segment_sum_matches_jax_scatter_add():
    _check_segment_sum(0)


def test_segment_sum_rows_outside_keep_join_no_segment():
    _check_segment_sum(1000)


@pytest.mark.parametrize("widths,S", [((36, 6), 24), ((9, 3), 300)])
def test_segment_sum_of_side_by_side_blocks_equals_separate_sums(widths, S):
    """The local BA sums Hcc | bc (42 columns) and Hpp | bp (12) in one
    launch each: every column keeps its own order, so the bits are those
    of separate sums."""
    rng = np.random.default_rng(sum(widths) + S)
    E = 4096
    key = torch.from_numpy(rng.integers(0, S, E))
    seg = make_segments(key, S, torch.from_numpy(rng.random(E) > 0.2))
    # magnitudes over six decades, so that the order of the adds shows
    parts = [torch.from_numpy((rng.normal(0, 1, (E, w)) *
                               10.0 ** rng.uniform(-3, 3, (E, 1)))
                              .astype(np.float32)) for w in widths]
    both = segment_sum(torch.cat(parts, dim=1), seg)
    assert both.shape == (S, sum(widths))
    assert torch.equal(both, torch.cat([segment_sum(p, seg) for p in parts],
                                       dim=1))
    assert torch.equal(segment_sum_ref(torch.cat(parts, dim=1), seg.key, S),
                       both)


def test_local_bundle_adjust_sums_three_blocks_a_step(monkeypatch):
    """45 segment sums a solve: 15 steps x (camera blocks Hcc | bc, 42
    columns; point blocks Hpp | bp, 12; coupling Wagg, 18)."""
    import airdos_tpu_torch.solvers.local_ba as lba
    widths = []

    def counted(vals, seg):
        widths.append(vals.shape[1])
        return segment_sum(vals, seg)

    monkeypatch.setattr(lba, "segment_sum", counted)
    arrays, intr = _ba_problem(False)
    lba.local_bundle_adjust(*(_t(a) for a in arrays), *intr)
    assert widths == [42, 12, 18] * 15


# ------------------------------------------------ triangulation / fusion
def _snapshot(jax_run):
    """Independent copies of the snapshot map for each package."""
    jm = jax_run["slam"].map
    return copy.deepcopy(jm), map_from(jm), jax_run["kf_id"]


def _tri_inputs(kf, nbrs, jax_slam):
    ext = jax_slam.frontend.extractor
    cam = jax_slam.config.camera
    free1 = (kf.mp_idx < 0) & kf.valid

    def stack(attr):
        return np.stack([getattr(n, attr) for n in nbrs])

    free2 = np.stack([(n.mp_idx < 0) & n.valid for n in nbrs])
    return (kf.xy_un, kf.octave, kf.u_right, kf.depth, kf.desc32, free1,
            kf.Rcw, kf.tcw, stack("xy_un"), stack("octave"), stack("u_right"),
            stack("depth"), stack("desc32"), free2, stack("Rcw"),
            stack("tcw"), cam.fx, cam.fy, cam.cx, cam.cy, cam.bf,
            np.asarray(ext.scales, np.float32), ext.sigma2,
            float(np.log(jax_slam.config.orb.scale_factor)),
            jax_slam.config.orb.n_levels)


def _to_port(args):
    """JAX-side positional arguments -> torch: descriptors as int32 bit
    views, integer arrays (octaves) as int64."""
    out = []
    for a in args:
        if isinstance(a, (int, float)):
            out.append(a)
            continue
        a = np.asarray(a)
        if a.dtype == np.uint32:
            out.append(desc_to_tensor(np.array(a), "cpu"))
        elif a.dtype.kind == "i":
            out.append(torch.from_numpy(a.astype(np.int64)))
        else:
            out.append(torch.from_numpy(np.array(a)))
    return out


def _agree(a, b):
    either = (a >= 0) | (b >= 0)
    return float(np.mean(a[either] == b[either])), int(either.sum())


def test_batched_triangulate_pair_matches_jax_vmap(jax_run):
    jmap, _, kf_id = _snapshot(jax_run)
    kf = jmap.kfs[kf_id]
    nbrs = [jmap.kfs[n] for n in kf.best_covisible(4)]
    assert len(nbrs) == 4
    args = _tri_inputs(kf, nbrs, jax_run["slam"])
    vm = jax.vmap(jax_triangulate, in_axes=(None,) * 8 + (0,) * 8 + (None,) * 9)
    ref = jax.device_get(vm(*(jnp.asarray(a) if isinstance(a, np.ndarray)
                              else a for a in args)))
    out = triangulate_pair(*_to_port(args))
    share, n = _agree(out.idx2.numpy(), np.asarray(ref.idx2))
    assert n > 20 and share >= 0.99, (share, n)
    both = out.valid.numpy() & np.asarray(ref.valid)
    assert both.sum() > 20, both.sum()
    assert np.abs(out.points.numpy()[both] - ref.points[both]).max() < 2e-3


def test_triangulate_pair_equals_the_composition_on_a_neighbourhood(
        jax_run, monkeypatch):
    """On the CPU triangulate_pair runs match_rows' epipolar mode and
    triangulate_rows_ref: on a keyframe and its 4 neighbours of the JAX
    run, the search's argmin and distance bit for bit the eager
    composition it replaced (tests/test_torch_triangulate_kernels.py),
    the triangulation within that file's stated tolerance."""
    from test_torch_triangulate_kernels import (_search_of,
                                                assert_close_where_valid,
                                                composition)
    jmap, _, kf_id = _snapshot(jax_run)
    kf = jmap.kfs[kf_id]
    nbrs = [jmap.kfs[n] for n in kf.best_covisible(4)]
    args = _to_port(_tri_inputs(kf, nbrs, jax_run["slam"]))
    got, best, dist = _search_of(args, monkeypatch)
    want, idx2, want_dist = composition(*args)
    assert torch.equal(best, idx2) and torch.equal(dist, want_dist)
    assert_close_where_valid(got, want, "neighbourhood")


def test_batched_fuse_candidates_matches_jax_vmap(jax_run):
    jmap, _, kf_id = _snapshot(jax_run)
    kf = jmap.kfs[kf_id]
    slam = jax_run["slam"]
    fuser = jbd.Fuser(slam.config, jmap, slam.frontend.extractor)
    targets = [jmap.kfs[n] for n in kf.best_covisible(10)][:fuser.max_targets]
    ids, n, args = fuser._assemble_neighborhood(kf, targets)
    ref = np.asarray(fuser._jit_batch(*args).feat_idx)
    out = fuse_candidates(*_to_port(jax.device_get(args))).feat_idx.numpy()
    assert out.shape == ref.shape == (fuser.max_targets + 1, args[0].shape[0])
    share, n_m = _agree(out, ref)
    assert n_m > 100 and share >= 0.95, (share, n_m)
    rows = targets + [kf] * (fuser.max_targets + 1 - len(targets))
    rows[fuser.max_targets] = kf
    acted = np.zeros_like(out, dtype=bool)
    for b, target in enumerate(rows):
        acted[b, :n] = [target.id not in jmap.points.obs[p] for p in ids]
    share, n_m = _agree(np.where(acted, out, -1), np.where(acted, ref, -1))
    assert n_m > 50 and share >= 0.99, (share, n_m)


def _fuse_composition(xw, desc_p, valid_p, normal_p, max_dist_p, min_dist_p,
                      R, t, ow, feat_xy, feat_ur, feat_oct, feat_desc,
                      feat_valid, fx, fy, cx, cy, bf, width, height,
                      scale_factors, sigma2, log_scale, n_levels, th=3.0):
    """matching/fuse.py's fuse_candidates as it was before its gate and
    reductions became match_rows' fuse mode: the eager [B, P, N]
    composition around the batched Hamming matrix."""
    from airdos_tpu_torch.ops.hamming_kernels import hamming_matrix_batched
    xc = torch.einsum("bij,pj->bpi", R, xw) + t[:, None, :]
    z = xc[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = fx * xc[..., 0] * iz + cx
    v = fy * xc[..., 1] * iz + cy
    ur = u - bf * iz
    in_img = (u >= 0) & (u < width) & (v >= 0) & (v < height) & (z > 0)
    po = xw[None] - ow[:, None, :]
    dist3d = torch.linalg.norm(po, dim=-1)
    dist_ok = (dist3d >= min_dist_p) & (dist3d <= max_dist_p)
    safe = torch.clamp(dist3d, min=1e-9)
    view_ok = torch.sum(po * normal_p[None], dim=-1) / safe > 0.5
    pred = torch.ceil(torch.log(torch.clamp(max_dist_p / safe, min=1e-9))
                      / log_scale).to(torch.int64)
    pred = torch.clamp(pred, 0, n_levels - 1)
    radius = (th * scale_factors[pred])[..., None]
    du = feat_xy[:, None, :, 0] - u[..., None]
    dv = feat_xy[:, None, :, 1] - v[..., None]
    win_ok = (torch.abs(du) < radius) & (torch.abs(dv) < radius)
    lf = feat_oct[:, None, :]
    oct_ok = (lf >= pred[..., None] - 1) & (lf <= pred[..., None] + 1)
    s2 = sigma2[feat_oct][:, None, :]
    e2 = du * du + dv * dv
    der = feat_ur[:, None, :] - ur[..., None]
    has_r = (feat_ur >= 0)[:, None, :]
    chi = torch.where(has_r, (e2 + der * der) / s2, e2 / s2)
    chi_ok = torch.where(has_r, chi <= 7.8, chi <= 5.99)
    frustum = in_img & dist_ok & view_ok & valid_p
    ok = win_ok & oct_ok & chi_ok & frustum[..., None] & feat_valid[:, None, :]
    D = hamming_matrix_batched(desc_p[None], feat_desc)
    D = torch.where(ok, D, torch.full_like(D, 1 << 10))
    best = torch.argmin(D, dim=2)
    bdist = torch.gather(D, 2, best[..., None])[..., 0]
    return torch.where(bdist <= 50, best, torch.full_like(best, -1)), bdist


def _random_fuse_args(seed):
    """Seeded fusion inputs around a synthetic camera: 300 points seen by
    4 targets of 500 features, a third of the features at a point's
    projection (a few pixels off, a few descriptor bits flipped)."""
    rng = np.random.default_rng(seed)
    P, N, B, L = 300, 500, 4, 8
    fx = fy = 400.0
    cx, cy, bf, W, H = 320.0, 180.0, 40.0, 640, 360
    xw = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P),
                   rng.uniform(2, 12, P)], 1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (P, 8), dtype=np.uint64).astype(np.uint32)
    R = np.stack([np.eye(3, dtype=np.float32)] * B)
    t = rng.normal(0, 0.05, (B, 3)).astype(np.float32)
    xc = xw[None] + t[:, None]
    u, v = fx * xc[..., 0] / xc[..., 2] + cx, fy * xc[..., 1] / xc[..., 2] + cy
    src = rng.integers(0, P, (B, N))
    near = rng.uniform(size=(B, N)) < 0.35
    bi = np.arange(B)[:, None]
    fxy = np.where(near[..., None],
                   np.stack([u[bi, src], v[bi, src]], -1)
                   + rng.normal(0, 1.5, (B, N, 2)),
                   rng.uniform([0, 0], [W, H], (B, N, 2))).astype(np.float32)
    fur = np.where(rng.uniform(size=(B, N)) < 0.7,
                   fxy[..., 0] - bf / xc[bi, src, 2], -1).astype(np.float32)
    fdesc = np.where(near[..., None], desc[src],
                     rng.integers(0, 2 ** 32, (B, N, 8), dtype=np.uint64))
    flip = np.left_shift(np.uint64(1), rng.integers(0, 32, (B, N, 8))
                         .astype(np.uint64))
    fdesc = (fdesc ^ np.where(rng.uniform(size=(B, N, 8)) < 0.2, flip, 0)) \
        .astype(np.uint32)
    dist = np.linalg.norm(xw, axis=1)
    normal = (xw / dist[:, None]).astype(np.float32)
    scales = (1.2 ** np.arange(L)).astype(np.float32)
    return [torch.from_numpy(a) for a in (
        xw, desc.view(np.int32), rng.uniform(size=(B, P)) < 0.8, normal,
        (dist * 1.3).astype(np.float32), (dist * 0.3).astype(np.float32),
        R, t, -t, fxy, fur, rng.integers(0, L, (B, N)),
        fdesc.view(np.int32), rng.uniform(size=(B, N)) < 0.95)] + [
        fx, fy, cx, cy, bf, W, H, torch.from_numpy(scales),
        torch.from_numpy(scales * scales), float(np.log(1.2)), L]


@pytest.mark.parametrize("inputs", ["neighbourhood", "random"])
def test_fuse_candidates_equals_the_composition_it_replaced(jax_run, inputs):
    """On the CPU fuse_candidates runs match_rows' plain version in fuse
    mode: bit for bit the eager composition fusion had, on a keyframe
    neighbourhood of the JAX run and on seeded random inputs."""
    if inputs == "neighbourhood":
        jmap, _, kf_id = _snapshot(jax_run)
        kf = jmap.kfs[kf_id]
        fuser = jbd.Fuser(jax_run["slam"].config, jmap,
                          jax_run["slam"].frontend.extractor)
        targets = [jmap.kfs[n] for n in kf.best_covisible(10)][
            :fuser.max_targets]
        args = _to_port(jax.device_get(
            fuser._assemble_neighborhood(kf, targets)[2]))
    else:
        args = _random_fuse_args(3)
    got = fuse_candidates(*args)
    feat_idx, dist = _fuse_composition(*args)
    assert int((feat_idx >= 0).sum()) > 20
    assert torch.equal(got.feat_idx, feat_idx)
    assert torch.equal(got.dist, dist)


# ----------------------------------------------------------- drivers
def _port_ext(jax_slam):
    return FrontEnd(config_from(jax_slam.config), device="cpu").extractor


def _assert_same_map(jm, tm, pos_tol=1e-4, tol=1e-4):
    """The same points, observations and keyframes; positions within
    pos_tol (a scalar or one bound per point id)."""
    jp, tp = jm.points, tm.points
    assert jp.n == tp.n
    n = jp.n
    np.testing.assert_array_equal(tp.bad[:n], jp.bad[:n])
    assert tp.obs[:n] == jp.obs[:n]
    np.testing.assert_array_equal(tp.n_obs[:n], jp.n_obs[:n])
    live = ~jp.bad[:n]
    err = np.linalg.norm(tp.pos[:n] - jp.pos[:n], axis=1)
    bound = np.broadcast_to(np.asarray(pos_tol, np.float64), (n,))
    assert (err[live] <= bound[live]).all(), \
        (err[live] - bound[live]).max()
    for kid, jk in jm.kfs.items():
        tk = tm.kfs[kid]
        np.testing.assert_array_equal(tk.mp_idx, jk.mp_idx)
        assert tk.covis == jk.covis and tk.bad == jk.bad
        assert np.abs(tk.Rcw - jk.Rcw).max() < tol
        assert np.abs(tk.tcw - jk.tcw).max() < tol


def test_static_local_ba_driver_matches_jax(jax_run):
    jmap, tmap, kf_id = _snapshot(jax_run)
    slam = jax_run["slam"]
    jbd.StaticLocalBA(slam.config, jmap, slam.frontend.extractor)(
        jmap.kfs[kf_id])
    ba = tbd.StaticLocalBA(config_from(slam.config), tmap, _port_ext(slam),
                           device="cpu")
    ba(tmap.kfs[kf_id])
    assert ba.n_solves == 1
    n = jmap.points.n
    d = np.linalg.norm(jmap.points.pos[:n] - jmap.kfs[kf_id].Ow, axis=1)
    _assert_same_map(jmap, tmap, pos_tol=1e-4 + 1e-5 * d ** 2)


def test_triangulator_driver_matches_jax(jax_run):
    jmap, tmap, kf_id = _snapshot(jax_run)
    slam = jax_run["slam"]
    jlm, tlm = JaxLocalMapper(slam.config, jmap), \
        LocalMapper(config_from(slam.config), tmap)
    n_before = jmap.points.n
    n_j = jbd.Triangulator(slam.config, jmap, slam.frontend.extractor,
                           jlm)(jmap.kfs[kf_id])
    n_t = tbd.Triangulator(config_from(slam.config), tmap, _port_ext(slam),
                           tlm, device="cpu")(tmap.kfs[kf_id])
    assert n_j > 0 and n_t == n_j
    assert tlm.recent_points == jlm.recent_points
    pos_tol = np.full(jmap.points.n, 1e-4)
    pos_tol[n_before:] = 2e-3
    _assert_same_map(jmap, tmap, pos_tol=pos_tol)


def test_fuser_driver_matches_jax(jax_run):
    jmap, tmap, kf_id = _snapshot(jax_run)
    slam = jax_run["slam"]
    jbd.Fuser(slam.config, jmap, slam.frontend.extractor)(jmap.kfs[kf_id])
    tbd.Fuser(config_from(slam.config), tmap, _port_ext(slam),
              device="cpu")(tmap.kfs[kf_id])
    _assert_same_map(jmap, tmap)
    np.testing.assert_array_equal(tmap.points.desc32, jmap.points.desc32)


# ------------------------------------------------- keyframe culling
def test_culled_keyframe_trajectory_chains_tcp_like_jax(jax_run):
    """Cull keyframe 1 in both packages' copies of the same map, then move
    every live keyframe by one rigid world transform: frames whose
    reference keyframe was culled must follow through Tcp, as in
    airdos_tpu."""
    e2e = jax_run["e2e"]
    jmap = copy.deepcopy(e2e["map"])
    tmap = map_from(e2e["map"])
    cfg = jax_run["slam"].config
    assert any(r.ref_kf_id == 1 for r in e2e["records"])
    before = JaxTracking.trajectory_tum(
        SimpleNamespace(records=e2e["records"], map=jmap))[2]
    JaxLocalMapper(cfg, jmap)._erase_keyframe(jmap.kfs[1])
    LocalMapper(config_from(cfg), tmap)._erase_keyframe(tmap.kfs[1])
    assert tmap.kfs[1].bad and tmap.kfs[1].Tcp is not None
    # new world = A x + b: Tcw' = Tcw A^T, tcw' = tcw - Rcw A^T b
    c, s = np.cos(0.3), np.sin(0.3)
    A = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    b = np.array([0.5, -0.2, 1.0], np.float32)
    for m in (jmap, tmap):
        for kf in m.kfs.values():
            if not kf.bad:
                R = kf.Rcw @ A.T
                kf.set_pose(R, kf.tcw - R @ b)
    want = JaxTracking.trajectory_tum(
        SimpleNamespace(records=e2e["records"], map=jmap))
    got = Tracking.trajectory_tum(
        SimpleNamespace(records=e2e["records"], map=tmap))
    assert np.abs(got[2] - want[2]).max() < 1e-5
    assert np.abs(got[1] - want[1]).max() < 1e-5
    np.testing.assert_allclose(got[2], before @ A.T + b, atol=1e-4)


# --------------------------------------------------------- end to end
def test_offline_system_matches_jax(jax_run, port_run):
    ref = jax_run["e2e"]
    assert ref["per"][:2] == [("OK", "init"), ("OK", "ref")]
    assert port_run["per"] == ref["per"]
    assert abs(port_run["n_kfs"] - ref["n_kfs"]) <= 1
    assert abs(port_run["n_points"] - ref["n_points"]) <= 0.1 * ref["n_points"]
    tol = max(0.15 * ref["ate"], 0.003)
    assert abs(port_run["ate"] - ref["ate"]) <= tol, \
        (port_run["ate"], ref["ate"])


def test_offline_system_runs_the_mapping_pass(port_run, tmp_path):
    slam = port_run["slam"]
    assert slam.static_ba.n_solves >= 1
    assert slam.keyframe_db is not None and slam.vocabulary is not None
    rep = slam.profiler.report()
    for stage in ("map.cull_points", "map.triangulate", "map.fuse",
                  "map.static_ba", "map.cull_kfs", "map.vocab"):
        assert rep[stage]["n"] >= 1, stage
    # the reference-KF branch after init went through BoW matching
    assert port_run["per"][1] == ("OK", "ref")
    # the exports of airdos_tpu's System
    slam.save_trajectory_kitti(tmp_path / "kitti.txt")
    slam.save_keyframe_trajectory_tum(tmp_path / "kf.txt")
    kitti = (tmp_path / "kitti.txt").read_text().splitlines()
    assert len(kitti) == N_E2E and len(kitti[0].split()) == 12
    kf_lines = (tmp_path / "kf.txt").read_text().splitlines()
    assert len(kf_lines) == slam.map.n_keyframes()
    rep = slam.timing_report()
    assert 0 < rep["median_s"] and 0 < rep["mean_s"]


def _dump(frames, tmp_path, tag):
    slam = System(config_from(small_config()), device="cpu")
    for data, _, _ in frames:
        slam.track_stereo(data)
    traj = tmp_path / f"traj_{tag}.txt"
    dump = tmp_path / f"dump_{tag}"
    slam.save_trajectory_tum(traj)
    slam.before_end(dump)
    slam.shutdown()
    return traj.read_bytes(), {f: (dump / f).read_bytes()
                               for f in ("KF.txt", "MP.txt", "Match.txt")}


def test_offline_port_is_deterministic(frames, tmp_path):
    traj_a, dumps_a = _dump([f for f in frames[:8]], tmp_path, "a")
    traj_b, dumps_b = _dump([f for f in frames[:8]], tmp_path, "b")
    assert traj_a == traj_b
    for f in dumps_a:
        assert dumps_a[f] == dumps_b[f], f
