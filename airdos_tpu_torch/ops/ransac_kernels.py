"""RANSAC hypotheses and refinement for EPnP and Horn on the card.

Relocalization's EPnP RANSAC (solvers/epnp.py epnp_ransac) and loop
closing's Sim3 RANSAC (solvers/sim3.py sim3_ransac) each run as two
launches of ``csrc/ransac.cu`` with a ``torch.argmax`` between them:

- hypotheses mode: a block a sample (sample_idx [H, m], m = 4 for EPnP, 3
  for Horn) solves its pose in float64 (EPnP by PCA control points, the
  12 x 12 null space by Jacobi and Gauss-Newton on the betas, Horn's
  quaternion by a 4 x 4 Jacobi), rounds it to float32 and runs the
  inlier test of all n points: Rs [H, 3, 3], ts [H, 3] (Horn: ss [H]),
  inliers [H, n], counts [H];
- refine mode: one block solves the weighted problem over all n points
  (weights the best hypothesis's inliers + 1e-6), re-tests, and keeps its
  result when it has at least as many inliers as the hypothesis.

The plain versions are the batched torch compositions beside their
dispatchers (solvers/epnp.py epnp_hypotheses_ref / epnp_refine_ref,
solvers/sim3.py sim3_hypotheses_ref / sim3_refine_ref). The EPnP kernel
fixes the eigensolver's free choices by rule, which the plain versions
follow with canonical=True (solvers/epnp.py epnp_pose says why it
matters). A sample that repeats an index is degenerate in both: a NaN
pose and no inliers (``repeats``). Each wrapper here takes CUDA tensors,
launches on the calling thread's current stream (built with nvcc at
first use into ``airdos_tpu_torch/_build/``, bound through ctypes) or
raises, and counts the launch, by thread and stream priority too.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from airdos_tpu_torch.ops import cuda_build

# csrc/ransac.cu RansacParams: 4 counts and flags, 15 pointers, 4 float32
_PARAMS = struct.Struct("<19q4f")
_SOURCE = cuda_build.CSRC / "ransac.cu"
_SIGNATURES = {"airdos_ransac_epnp": [ctypes.c_void_p, ctypes.c_void_p],
               "airdos_ransac_horn": [ctypes.c_void_p, ctypes.c_void_p]}
_lib = None                     # the loaded library, once built

# the four launches: (solver, mode)
_counters = {name: cuda_build.LaunchCounter() for name in (
    "epnp_hypotheses", "epnp_refine", "horn_hypotheses", "horn_refine")}


def epnp_hypotheses_launches() -> int:
    return _counters["epnp_hypotheses"].total


def epnp_refine_launches() -> int:
    return _counters["epnp_refine"].total


def horn_hypotheses_launches() -> int:
    return _counters["horn_hypotheses"].total


def horn_refine_launches() -> int:
    return _counters["horn_refine"].total


def launches() -> int:
    """ransac.cu launches of every mode since the last reset_launches()."""
    return sum(c.total for c in _counters.values())


def launch_tally() -> dict:
    """{(mode's name, thread name, stream priority): launches} since the
    last reset_launches()."""
    return {(name,) + key: n for name, c in _counters.items()
            for key, n in c.tally().items()}


def reset_launches() -> None:
    for c in _counters.values():
        c.reset()


def build():
    """Compile csrc/ransac.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def repeats(sample_idx: torch.Tensor) -> torch.Tensor:
    """[H] bool: the samples [H, m] that repeat an index (degenerate)."""
    m = sample_idx.shape[1]
    bad = torch.zeros(sample_idx.shape[0], dtype=torch.bool,
                      device=sample_idx.device)
    for i in range(m):
        for j in range(i):
            bad = bad | (sample_idx[:, i] == sample_idx[:, j])
    return bad


def _ptr(x) -> int:
    return 0 if x is None else x.data_ptr()


def _check_points(a, b, valid, gates, b_cols):
    """Raise unless a [n, 3], b [n, b_cols] and the gates [n] are
    contiguous float32 and valid [n] bool on a's CUDA device."""
    dev = a.device
    if not a.is_cuda:
        raise ValueError(f"the points must be CUDA tensors, got {dev}")
    if a.dim() != 2:
        raise ValueError(f"the points must be [n, 3], got {tuple(a.shape)}")
    n = a.shape[0]
    f32 = torch.float32
    cuda_build.check_tensor("points", a, f32, (n, 3), dev)
    cuda_build.check_tensor("observations", b, f32, (n, b_cols), dev)
    cuda_build.check_tensor("valid", valid, torch.bool, (n,), dev)
    for g in gates:
        cuda_build.check_tensor("gate", g, f32, (n,), dev)
    if n == 0:
        raise ValueError("a RANSAC needs points")
    return n, dev


def _check_samples(sample_idx, m, dev):
    if sample_idx.dim() != 2 or sample_idx.shape[0] == 0:
        raise ValueError(f"sample_idx must be [H, {m}] with H > 0, got "
                         f"{tuple(sample_idx.shape)}")
    cuda_build.check_tensor("sample_idx", sample_idx, torch.int32,
                            (sample_idx.shape[0], m), dev)
    return sample_idx.shape[0]


def _check_best(n, dev, R_b, t_b, s_b, inl_b):
    f32 = torch.float32
    cuda_build.check_tensor("R_b", R_b, f32, (3, 3), dev)
    cuda_build.check_tensor("t_b", t_b, f32, (3,), dev)
    if s_b is not None:
        cuda_build.check_tensor("s_b", s_b, f32, (), dev)
    cuda_build.check_tensor("inl_b", inl_b, torch.bool, (n,), dev)


def _launch(entry: str, counter: str, dev, n, n_hyp, refine, fix_scale,
            a, b, valid, gate1, gate2, samples, R_b, t_b, s_b, inl_b,
            fx, fy, cx, cy, horn: bool):
    """One launch; returns (R [n_hyp, 3, 3], t [n_hyp, 3], s [n_hyp] or
    None, inliers [n_hyp, n], counts [n_hyp])."""
    global _lib
    R = torch.empty((n_hyp, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((n_hyp, 3), dtype=torch.float32, device=dev)
    s = torch.empty(n_hyp, dtype=torch.float32, device=dev) if horn else None
    inl = torch.empty((n_hyp, n), dtype=torch.bool, device=dev)
    counts = torch.empty(n_hyp, dtype=torch.int64, device=dev)
    block = ctypes.create_string_buffer(_PARAMS.pack(
        n, n_hyp, int(refine), int(fix_scale), _ptr(a), _ptr(b),
        _ptr(valid), _ptr(gate1), _ptr(gate2), _ptr(samples), _ptr(R_b),
        _ptr(t_b), _ptr(s_b), _ptr(inl_b), R.data_ptr(), t.data_ptr(),
        _ptr(s), inl.data_ptr(), counts.data_ptr(), fx, fy, cx, cy))
    if _lib is None:
        _lib = cuda_build.library(_SOURCE, _SIGNATURES)
    stream = torch.cuda.current_stream(dev)
    with cuda_build.on_device(dev):
        err = getattr(_lib, entry)(ctypes.addressof(block),
                                   stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"{counter} kernel launch failed: cudaError {err}")
    _counters[counter].count(stream.priority)
    return R, t, s, inl, counts


def epnp_hypotheses_cuda(pw, uv, valid, max_err2, sample_idx,
                         fx, fy, cx, cy):
    """Every EPnP hypothesis of sample_idx [H, 4] (int32) in one launch:
    (Rs [H, 3, 3], ts [H, 3], inliers [H, n], counts [H])."""
    n, dev = _check_points(pw, uv, valid, (max_err2,), 2)
    H = _check_samples(sample_idx, 4, dev)
    R, t, _, inl, counts = _launch(
        "airdos_ransac_epnp", "epnp_hypotheses", dev, n, H, False, True,
        pw, uv, valid, max_err2, max_err2, sample_idx, None, None, None,
        None, fx, fy, cx, cy, horn=False)
    return R, t, inl, counts


def epnp_refine_cuda(pw, uv, valid, max_err2, R_b, t_b, inl_b,
                     fx, fy, cx, cy):
    """The weighted EPnP over all points (weights inl_b + 1e-6), kept when
    it has at least as many inliers as (R_b, t_b, inl_b), in one launch:
    (R [3, 3], t [3], inliers [n], n_inliers [])."""
    n, dev = _check_points(pw, uv, valid, (max_err2,), 2)
    _check_best(n, dev, R_b, t_b, None, inl_b)
    R, t, _, inl, counts = _launch(
        "airdos_ransac_epnp", "epnp_refine", dev, n, 1, True, True,
        pw, uv, valid, max_err2, max_err2, None, R_b, t_b, None, inl_b,
        fx, fy, cx, cy, horn=False)
    return R[0], t[0], inl[0], counts[0]


def horn_hypotheses_cuda(x1, x2, valid, max_err1, max_err2, sample_idx,
                         fx, fy, cx, cy, fix_scale: bool):
    """Every Horn (Sim3) hypothesis of sample_idx [H, 3] (int32) in one
    launch: (Rs [H, 3, 3], ts [H, 3], ss [H], inliers [H, n], counts
    [H])."""
    n, dev = _check_points(x1, x2, valid, (max_err1, max_err2), 3)
    H = _check_samples(sample_idx, 3, dev)
    return _launch("airdos_ransac_horn", "horn_hypotheses", dev, n, H,
                   False, fix_scale, x1, x2, valid, max_err1, max_err2,
                   sample_idx, None, None, None, None, fx, fy, cx, cy,
                   horn=True)


def horn_refine_cuda(x1, x2, valid, max_err1, max_err2, R_b, t_b, s_b,
                     inl_b, fx, fy, cx, cy, fix_scale: bool):
    """Horn over all pairs (weights inl_b + 1e-6), kept when it has at
    least as many inliers as (R_b, t_b, s_b, inl_b), in one launch: (R
    [3, 3], t [3], s [], inliers [n], n_inliers [])."""
    n, dev = _check_points(x1, x2, valid, (max_err1, max_err2), 3)
    _check_best(n, dev, R_b, t_b, s_b, inl_b)
    R, t, s, inl, counts = _launch(
        "airdos_ransac_horn", "horn_refine", dev, n, 1, True, fix_scale,
        x1, x2, valid, max_err1, max_err2, None, R_b, t_b, s_b, inl_b,
        fx, fy, cx, cy, horn=True)
    return R[0], t[0], s[0], inl[0], counts[0]


# ------------------------------ the kernels against the plain versions

# A minimal sample's hypothesis is a float64 solve rounded once, here and
# in the plain versions' EPnP (Horn's plain version solves in float32,
# which its closed form keeps to float32 rounding).  Where a sample is
# ill-posed, the solve amplifies rounding (EPnP's Gauss-Newton on the
# betas most), so the per-hypothesis pose tolerance holds on the
# well-posed samples: those where the plain version solved in float32 and
# in float64 lies within POSE_TOL / 2 of itself.
POSE_TOL = 5e-4           # a hypothesis's R, t (and s)
COUNT_SHARE = 0.90        # hypotheses with the plain version's inlier count
REFINE_TOL = 1e-4         # the refined R, t (m) and s (relative)
REFINE_INLIER_SHARE = 0.99


def pose_rows(out) -> torch.Tensor:
    """[H, 12] (EPnP) or [H, 13] (Horn) float64 rows R, t (, s) of a
    hypotheses result (R, t, [s,] inliers, counts)."""
    R, t = out[0], out[1]
    parts = [R.reshape(R.shape[0], 9), t.reshape(t.shape[0], 3)]
    if len(out) == 5:
        parts.append(out[2].reshape(-1, 1))
    return torch.cat([p.to(torch.float64) for p in parts], dim=1)


def hypotheses_held(got, plain, other, sample_idx):
    """The kernel's hypotheses against the plain version's, each (R, t, [s,]
    inliers, counts); other is the plain version solved in the other
    precision (float32 for EPnP, float64 for Horn), which tells the
    well-posed samples.  Held: degenerate samples NaN with no inliers in
    both, counts equal on COUNT_SHARE of the hypotheses, poses within
    POSE_TOL on the well-posed samples.  Returns (held, stats)."""
    bad = repeats(sample_idx.to(torch.int64))
    g, p, o = pose_rows(got), pose_rows(plain), pose_rows(other)
    cg, cp, co = got[-1].cpu(), plain[-1].cpu(), other[-1].cpu()
    bad_cpu = bad.cpu()
    nan_ok = bool(torch.isnan(g[bad]).all() and torch.isnan(p[bad]).all()
                  and (cg[bad_cpu] == 0).all() and (cp[bad_cpu] == 0).all())
    good = ~bad & torch.isfinite(p).all(1) & torch.isfinite(o).all(1)
    well = good & ((p - o).abs().amax(1) < POSE_TOL / 2)
    gap = float((g - p)[well].abs().max()) if bool(well.any()) else 0.0
    gap_all = (g - p)[~bad].abs().amax(1)
    share = float((cg == cp).double().mean())
    stats = dict(hypotheses=int(bad.numel()), degenerate=int(bad.sum()),
                 well_posed=int(well.sum()), pose_gap=gap,
                 pose_gap_median=float(gap_all.nan_to_num(0.0).median())
                 if bool((~bad).any()) else 0.0, count_share=share,
                 count_share_other=float((cg == co).double().mean()),
                 degenerate_nan=nan_ok)
    return nan_ok and gap <= POSE_TOL and share >= COUNT_SHARE, stats


def refine_held(got, plain, plain64):
    """The kernel's refine against the plain version's (each (R, t, [s,]
    inliers, n_inliers)): R and t within REFINE_TOL, s within REFINE_TOL of
    itself, or, where the weighted problem is ill-conditioned, no farther
    from the plain version than twice the plain version is from itself in
    float64 (plain64); REFINE_INLIER_SHARE of the inlier flags equal.
    Returns (held, stats)."""
    def gaps(a, b):
        s_gap = float(((a[2] - b[2]) / b[2]).abs()) if len(a) == 5 else 0.0
        return (float((a[0] - b[0]).abs().max()),
                float((a[1] - b[1]).abs().max()), s_gap)

    mine = gaps(got, plain)
    own = gaps(plain, plain64)
    share = float((got[-2] == plain[-2]).double().mean())
    stats = dict(R_gap=mine[0], t_gap=mine[1], s_gap=mine[2],
                 plain_float32_gap=max(own), inlier_share=share,
                 n_inliers=(int(got[-1]), int(plain[-1])))
    close = max(mine) <= max(REFINE_TOL, 2.0 * max(own))
    return close and share >= REFINE_INLIER_SHARE, stats
