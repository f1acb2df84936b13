"""The map-scale global BA on one device and sharded over a mesh, in turns.

    python3 tools/mesh_scale.py [n_ranks]      # default 4

Run from the repository root on a CUDA machine.  chip_smoke.py's corridor
of phase map scale (C = 1000 keyframes, P = 100,000 points, ~300
observations a keyframe) in GlobalBA's schedule (solve_global_ba), solved
on cuda:0 and sharded over make_mesh(n_ranks): one rank a card, so the
machine needs n_ranks cards, or n_ranks virtual ranks on one card when
AIRDOS_TORCH_VIRTUAL_DEVICES asks for them.  The order is single,
sharded, sharded, single; prints each solve's host seconds (ended by a
synchronize), both final reprojection chi2 and the largest pose gap
between the two solves, with the card's name and power limit.  It
checks nothing.
"""
from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def main(n_ranks: int) -> None:
    from airdos_tpu_torch.convert import to_device
    from airdos_tpu_torch.parallel.sharded_ba import make_mesh
    from airdos_tpu_torch.slam.ba_driver import solve_global_ba

    smi = chip_smoke.phase_environment()
    chip_smoke.phase_build()
    mesh = make_mesh(n_ranks, "cuda")
    arrays, cam, _, _ = chip_smoke._corridor(
        np.random.default_rng(chip_smoke.SEED), 1000, 100_000, 300)
    if len(arrays[5]) % n_ranks:
        raise SystemExit(f"{len(arrays[5])} edges: not a multiple of "
                         f"{n_ranks} ranks")
    dev = [to_device(a, "cuda") for a in arrays]
    secs, outs = {}, {}
    for name in ("single", "sharded", "sharded", "single"):
        m = mesh if name == "sharded" else None
        s, (out,) = chip_smoke._timed_device(
            lambda: solve_global_ba(*dev, *cam, mesh=m), reps=1)
        secs.setdefault(name, []).extend(s)
        outs[name] = out
    chi2 = {k: chip_smoke._chi2_sum(dev, cam, *v) for k, v in outs.items()}
    gap_R = float((outs["single"][0] - outs["sharded"][0]).abs().max())
    gap_t = float((outs["single"][1] - outs["sharded"][1]).abs().max())
    print(f"[mesh-scale] {mesh.describe()}: global BA C 1000, P 100000, "
          f"E {len(arrays[5])} ({len(arrays[5]) // n_ranks} a rank), 4 "
          f"calls x 5 steps; s a solve: single "
          f"{[round(x, 3) for x in secs['single']]}, sharded "
          f"{[round(x, 3) for x in secs['sharded']]}; chi2 single "
          f"{chi2['single']:.6g}, sharded {chi2['sharded']:.6g}; largest "
          f"gap R {gap_R:.2e}, t {gap_t:.2e} m on {smi}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if sys.argv[1:] else 4)
