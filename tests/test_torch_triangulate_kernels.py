"""Triangulation's epipolar search and triangulation (csrc/match.cu's
epipolar mode, csrc/triangulate.cu) through their plain versions, on the
CPU.

- triangulate_pair (the prelude, match_rows' epipolar mode and
  triangulate_rows_ref) against the eager composition it replaced (kept
  in tests/torch_triangulate_cases.py as ``composition``: the [B, N1, N2]
  gate around the batched
  Hamming matrix and the ~150 ops on [B, N1] rows), on seeded scenes: 3-D
  points seen by a keyframe and B neighbours at 640 x 360, 8 octaves,
  stereo depth on most features, a few descriptor bits flipped.  The
  search's argmin and distance are equal bit for bit.  The plain
  version's explicit three- and four-term sums and norms round where the
  composition's matmuls, einsums and linalg.norm did not: where both are
  valid the points agree within 1e-5 relative (plus 1e-6 m) and the
  stereo flags are equal, and valid differs on at most 0.5% of the
  matched rows.  triangulate_rows_ref at the composition's argmin is held
  the same way.
- Rows with no gated pair, zero parallax (a neighbour at the keyframe's
  pose: the stereo points), depths that are not positive: the plain
  version's flags as the composition's.
- The dispatchers: CPU tensors run the plain versions and never reach a
  kernel's wrapper, which raises on CPU tensors.
"""
import numpy as np
import pytest
import torch

import airdos_tpu_torch.matching.epipolar as epi
import airdos_tpu_torch.ops.match_kernels as mk
import airdos_tpu_torch.ops.triangulate_kernels as tk
from test_torch_ops import one_torch_thread  # noqa: F401 (autouse)
from torch_triangulate_cases import _composition_rows, composition, scene

REL, ABS = 1e-5, 1e-6              # points: where both are valid
VALID_SHARE = 0.005                # valid may differ on this share


def _search_of(args, monkeypatch):
    """triangulate_pair(*args) and the best / dist its search handed to
    triangulate_rows."""
    seen = {}
    rows = epi.triangulate_rows

    def spy(best, dist, *rest):
        seen["best"], seen["dist"] = best, dist
        return rows(best, dist, *rest)

    monkeypatch.setattr(epi, "triangulate_rows", spy)
    out = epi.triangulate_pair(*args)
    return out, seen["best"], seen["dist"]


def assert_close_where_valid(got, want, what=""):
    """got and want (TriangulationResult): valid differs on at most
    VALID_SHARE of the rows either matched; where both are valid, idx2
    and the stereo flags equal and the points within REL relative plus
    ABS (m)."""
    gv, wv = got.valid.numpy(), want.valid.numpy()
    either = gv | wv
    assert either.sum() > 20, what
    differ = int((gv != wv).sum())
    assert differ <= VALID_SHARE * either.sum(), (what, differ, either.sum())
    both = gv & wv
    np.testing.assert_array_equal(got.idx2.numpy()[both],
                                  want.idx2.numpy()[both], err_msg=what)
    for name in ("from_stereo1", "from_stereo2"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[both],
                                      getattr(want, name).numpy()[both],
                                      err_msg=f"{what} {name}")
    gp, wp = got.points.numpy()[both], want.points.numpy()[both]
    np.testing.assert_allclose(gp, wp, rtol=REL, atol=ABS, err_msg=what)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_triangulate_pair_equals_the_composition_it_replaced(seed,
                                                             monkeypatch):
    """On the CPU triangulate_pair runs match_rows' epipolar mode and
    triangulate_rows_ref: the search's argmin and distance bit for bit the
    composition's, the triangulation within the stated tolerance."""
    args = scene(seed)
    got, best, dist = _search_of(args, monkeypatch)
    want, idx2, want_dist = composition(*args)
    assert torch.equal(best, idx2)
    assert torch.equal(dist, want_dist)
    assert int(want.valid.sum()) > 100
    assert_close_where_valid(got, want, f"seed {seed}")


@pytest.mark.parametrize("seed", [4, 5])
def test_triangulate_rows_ref_at_the_compositions_argmin(seed):
    """triangulate_rows_ref on the composition's own argmin and distance
    (the search held apart) against the composition's triangulation, and
    both against a float64 run of the plain version: where all three are
    valid the plain version's worst point error is within 1.5 times the
    composition's (the rays of low parallax are ill-conditioned in
    float32 either way)."""
    args = scene(seed)
    want, idx2, dist = composition(*args)
    xy1, oct1, ur1, depth1, _, _, R1, t1, xy2, oct2, ur2, depth2, _, _, \
        R2, t2, fx, fy, cx, cy, bf, sf, s2, ls, _ = args
    C1w = -R1.T @ t1
    C2w = -torch.einsum("bji,bj->bi", R2, t2)
    got = tk.triangulate_rows_ref(idx2, dist, xy1, oct1, ur1, depth1, R1, t1,
                                  xy2, oct2, ur2, depth2, R2, t2, C1w, C2w,
                                  fx, fy, cx, cy, bf, sf, s2, ls)
    assert_close_where_valid(got, want, f"seed {seed}")
    f64 = [x.double() if torch.is_tensor(x) and x.is_floating_point() else x
           for x in (idx2, dist, xy1, oct1, ur1, depth1, R1, t1, xy2, oct2,
                     ur2, depth2, R2, t2, C1w, C2w, fx, fy, cx, cy, bf, sf,
                     s2, ls)]
    exact = tk.triangulate_rows_ref(*f64)
    both = got.valid & want.valid & exact.valid
    assert int(both.sum()) > 100

    def worst(x):
        return float((x.points[both].double() - exact.points[both]).abs()
                     .max())

    # the plain version no farther from float64 than the composition
    assert worst(got) <= 1.5 * worst(want), (worst(got), worst(want))


def test_triangulate_rows_ref_edge_rows():
    """Rows with no gated pair (best 0, dist BIG), a neighbour at the
    keyframe's own pose (zero parallax: the stereo point or nothing) and
    depths that are not positive: the plain version's flags equal the
    composition's on every row, and its points within the tolerance
    where valid."""
    args = scene(7, same_pose=True)
    want, idx2, dist = composition(*args)
    xy1, oct1, ur1, depth1, _, _, R1, t1, xy2, oct2, ur2, depth2, _, _, \
        R2, t2, fx, fy, cx, cy, bf, sf, s2, ls, _ = args
    dist = dist.clone()
    dist[:, ::5] = mk.BIG                     # no gated pair: best stays
    depth1 = torch.where(torch.arange(len(depth1)) % 7 == 0,
                         torch.zeros_like(depth1), depth1)
    want = _composition_rows(idx2, dist, xy1, oct1, ur1, depth1, R1, t1,
                             xy2, oct2, ur2, depth2, R2, t2, fx, fy, cx, cy,
                             bf, sf, s2, ls)
    C1w = -R1.T @ t1
    C2w = -torch.einsum("bji,bj->bi", R2, t2)
    got = tk.triangulate_rows_ref(idx2, dist, xy1, oct1, ur1, depth1, R1, t1,
                                  xy2, oct2, ur2, depth2, R2, t2, C1w, C2w,
                                  fx, fy, cx, cy, bf, sf, s2, ls)
    assert not got.valid[:, ::5].any()
    # the neighbour at the keyframe's pose: no triangulated point, only
    # stereo ones
    same = got.valid[0]
    stereo = got.from_stereo1[0] | got.from_stereo2[0]
    assert same.any() and stereo[same].all()
    assert_close_where_valid(got, want, "edge rows")


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On CPU tensors triangulate_pair never reaches a kernel's wrapper,
    and the wrappers raise on CPU tensors (no launch counted)."""
    def kernel(*args, **kwargs):
        raise AssertionError("a kernel wrapper ran on CPU tensors")

    args = scene(8, B=2, N1=300, N2=280)
    n = (mk.launches(), mk.epipolar_launches(), tk.launches())
    with monkeypatch.context() as m:
        m.setattr(mk, "match_rows_cuda", kernel)
        m.setattr(tk, "triangulate_rows_cuda", kernel)
        out = epi.triangulate_pair(*args)
    assert int(out.valid.sum()) > 5
    best = torch.zeros((2, 300), dtype=torch.int64)
    with pytest.raises(ValueError):
        tk.triangulate_rows_cuda(best, best.int(), *args[:4], *args[6:12],
                                 *args[14:16], args[7], args[15],
                                 *args[16:24])
    assert (mk.launches(), mk.epipolar_launches(), tk.launches()) == n
