"""How far the port's global BA lands from airdos_tpu's when schur_camera's
plain version sums a camera's rows in another order, on the CPU.

    python3 tests/torch_camera_order.py

For each order, global_bundle_adjust runs through the plain versions on
tests/test_torch_loop_solvers.py's two problems ("small", 4 + 8 steps;
"corridor", 2 + 3 steps; 48 CG iterations) and prints the largest gap to
airdos_tpu's result in R, t and the points seen twice, and whether the
edge inliers agree.  The test's limits are 1e-4 (R, t) and 1e-3 m
(points).  The orders:

- walk32: each camera's rows in walk order in float32 (the shipped
  ``camera_sums_ref``, airdos_tpu's scatter-add order);
- walk64: the same order in float64, rounded to float32 once;
- lanes32: 32 lanes (lane j adds rows j, j + 32, ...) and a halving tree
  in float32;
- lanes64: the same in float64, rounded once;

both from tools/kernel_split.py ``camera_sums_lanes_ref`` (lanes64 is the
kernel variant that it times on the card).  Where the gap comes from:

- walk32 / lanes32, CG in float64: the whole CG (both halves, the
  update and its state) in float64 from the float32 Gauss-Newton pieces,
  its x rounded to float32 once a step;
- lanes32, cost in float64: the LM cost that accepts or rejects a step
  summed in float64;
- walk32, all in float64: the whole solve in float64 (its float32 inputs
  widened).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests"), str(REPO / "tools")]

import jax.numpy as jnp  # noqa: E402

import test_torch_loop_solvers as T  # noqa: E402
from airdos_tpu_torch.ops import ba_global as bg  # noqa: E402
from airdos_tpu_torch.ops.segment_kernels import segment_sum_ref  # noqa: E402
from kernel_split import camera_sums_lanes_ref  # noqa: E402


def walk64(w_c, walk_c, z):
    zg = z[walk_c.other.long()]
    W = w_c.reshape(-1, 6, 3)
    y = W[:, :, 0] * zg[:, 0:1]
    for m in range(1, 3):
        y = y + W[:, :, m] * zg[:, m:m + 1]
    return segment_sum_ref(y.double(), walk_c.key, walk_c.n).to(y.dtype)


def lanes32(*a):
    return camera_sums_lanes_ref(*a, wide=False)


ORDERS = {"walk32": bg.camera_sums_ref, "walk64": walk64,
          "lanes32": lanes32, "lanes64": camera_sums_lanes_ref}

# patches of the solver's source, (line, replacement): its CG in float64;
# its LM cost summed in float64
PATCHES = {
    "cg64": [
        ("        state = cg_start(b_red, D_inv)\n"
         "        point = point_half(w_p, walk_p, state.p, free_c, Hpp_inv)\n"
         "        camera = camera_half(w_c, walk_c, state, Hcc_d, D_inv, "
         "free_c, P)\n",
         "        f64, D64 = free_c.double(), D_inv.double()\n"
         "        state = cg_start(b_red.double(), D64)\n"
         "        point = point_half(w_p.double(), walk_p, state.p, f64,\n"
         "                           Hpp_inv.double())\n"
         "        camera = camera_half(w_c.double(), walk_c, state,\n"
         "                             Hcc_d.double(), D64, f64, P)\n"),
        ("        dx_c = state.x * cam_free\n",
         "        dx_c = state.x.to(dtype) * cam_free\n"),
    ],
    "cost64": [
        ("            return psum(torch.sum(rho * active))\n",
         "            return psum(torch.sum((rho * active).double()))\n"),
    ],
}


def patched_solver(name):
    """global_bundle_adjust from a patched copy of solvers/global_ba.py
    (the package is not changed)."""
    src = (REPO / "airdos_tpu_torch/solvers/global_ba.py").read_text()
    for line, repl in PATCHES[name]:
        assert src.count(line) == 1, line
        src = src.replace(line, repl)
    space: dict = {"__name__": "global_ba_" + name}
    exec(compile(src, "global_ba_" + name, "exec"), space)
    return space["global_bundle_adjust"]


def _wide(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.astype(np.float64) if a.dtype == np.float32
                            else a)


# name -> (camera sums, solver, input conversion)
VARIANTS = {name: (fn, None, T._t) for name, fn in ORDERS.items()}
VARIANTS["walk32, CG in float64"] = (bg.camera_sums_ref, "cg64", T._t)
VARIANTS["lanes32, CG in float64"] = (lanes32, "cg64", T._t)
VARIANTS["lanes32, cost in float64"] = (lanes32, "cost64", T._t)
VARIANTS["walk32, all in float64"] = (bg.camera_sums_ref, None, _wide)


def main() -> None:
    shipped = bg.camera_sums_ref
    solvers = {None: T.tgba.global_bundle_adjust,
               **{name: patched_solver(name) for name in PATCHES}}
    try:
        for name, (fn, solver, conv) in VARIANTS.items():
            bg.camera_sums_ref = fn
            for problem, iters in (("small", (4, 8)), ("corridor", (2, 3))):
                rng = np.random.default_rng(0)
                args = T._small_gba_problem(rng) if problem == "small" \
                    else T._corridor(rng)
                arrays, scalars = args[:10], args[10:]
                kw = dict(iters1=iters[0], iters2=iters[1], cg_iters=48)
                want = T.jax_gba(*(jnp.asarray(a) for a in arrays),
                                 *scalars, **kw)
                got = solvers[solver](*(conv(a) for a in arrays),
                                      *scalars, **kw)
                e_r = np.abs(got.R.numpy() - np.asarray(want.R)).max()
                e_t = np.abs(got.t.numpy() - np.asarray(want.t)).max()
                twice = np.bincount(arrays[6],
                                    minlength=arrays[3].shape[0]) >= 2
                gap = np.linalg.norm(got.points.numpy()
                                     - np.asarray(want.points), axis=1)
                same = bool((got.edge_inlier.numpy()
                             == np.asarray(want.edge_inlier)).all())
                print(f"{name} {problem}: R {e_r:.3g} t {e_t:.3g} points "
                      f"{gap[twice].max():.3g} m, inliers equal {same}",
                      flush=True)
    finally:
        bg.camera_sums_ref = shipped


if __name__ == "__main__":
    main()
