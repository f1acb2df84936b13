"""The online loop stall of the pillar orbit with the essential graph's and
the background global BA's per-step gate waits (airdos_tpu_torch/utils/
gate.py) on and off, in turns on one card (on, off, off, on, ...), with
the mapping load of each run beside it.

    python3 tools/online_stall_ab.py

Run from the repository root on a CUDA machine.  Each run is
chip_smoke.py's phase 13a run (`_run_online_pillar`); "off" calls the two
solvers without the `step_hook` they are given.  Prints a row per run and
the medians per mode; it checks nothing.
"""
from __future__ import annotations

import collections
import contextlib
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


@contextlib.contextmanager
def _step_waits(on: bool):
    """The two solvers as shipped (on), or without their step hooks."""
    from airdos_tpu_torch.slam import ba_driver, loop_closing
    shipped = (ba_driver.global_bundle_adjust,
               loop_closing.optimize_essential_graph)

    def no_hook(solver):
        def call(*args, **kwargs):
            kwargs.pop("step_hook", None)
            return solver(*args, **kwargs)
        return call
    if not on:
        ba_driver.global_bundle_adjust = no_hook(shipped[0])
        loop_closing.optimize_essential_graph = no_hook(shipped[1])
    try:
        yield
    finally:
        ba_driver.global_bundle_adjust, \
            loop_closing.optimize_essential_graph = shipped


def main(runs: int = 2):
    smi = chip_smoke.phase_environment()
    chip_smoke.phase_build()
    orbit, _ = chip_smoke._orbit_frames(chip_smoke.N_ORBIT)
    modes = ("on", "off")
    order = [m for i in range(runs)
             for m in (modes if i % 2 == 0 else modes[::-1])]
    rows = collections.defaultdict(list)
    for k, mode in enumerate(order):
        with _step_waits(mode == "on"):
            slam, states, st = chip_smoke._run_online_pillar(orbit)
        spans = slam.profiler.stages
        row = dict(med=st["med"] * 1e3,
                   p90=float(np.percentile(st["times"][20:], 90)) * 1e3,
                   worst=(st["worst"] or 0.0) * 1e3, bound=st["bound"] * 1e3,
                   eg=sum(spans.get("loop.essential_graph", [0.0])) * 1e3,
                   gba=sum(spans.get("gba.solve", [0.0])) * 1e3)
        rows[mode].append(row)
        lc = slam.loop_closer
        print(f"[stall-ab] run {k} step waits {mode}: " + ", ".join(
            f"{key} {v:.2f}" for key, v in row.items())
            + f" ms; loops {lc.n_loops_closed if lc else 0}, states "
            f"{dict(collections.Counter(states))}; "
            f"{chip_smoke._mapping_load(st)} on {smi}", flush=True)
    for mode in modes:
        r = rows[mode]
        print(f"[stall-ab] step waits {mode}: median over {len(r)} runs: "
              f"worst {np.median([x['worst'] for x in r]):.2f} ms, worst / "
              f"median {np.median([x['worst'] / x['med'] for x in r]):.3f}, "
              f"frame median {np.median([x['med'] for x in r]):.2f} ms, "
              f"runs within the bound "
              f"{sum(x['worst'] < x['bound'] for x in r)}/{len(r)} on {smi}",
              flush=True)


if __name__ == "__main__":
    main()
