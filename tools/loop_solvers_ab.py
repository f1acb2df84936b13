"""The loop correction's two solvers, this checkout against another, on
the card.

    python3 tools/loop_solvers_ab.py [--parent DIR] [--rounds N] [--mesh N]

Runs the global BA in GlobalBA's schedule (``slam/ba_driver.py``
``solve_global_ba``: four calls of five Gauss-Newton steps) and the
essential graph (``solvers/pose_graph.py`` ``optimize_essential_graph``,
20 steps) over chip_smoke.py's corridor at two sizes: the map scale (C
1000, P 100,000, ~300 observations a keyframe; the essential graph over
the 1000 keyframes with one loop edge, D 7000) and the pillar orbit's
(C 64, P 8192, ~1,000 observations a keyframe, as pillar-84's loop
solves them; D 448).  Each checkout runs in a process of its own: this
one and, with --parent, the one unpacked at DIR (``git archive``), in
turns (parent, change, change, parent by default).  Prints per solver
and size the host seconds of two solves (each ended by a synchronize),
the device busy time and kernel count of a third (torch.profiler), and
the card's name and power limit.  With --mesh N, also the map-scale
global BA sharded over a mesh of N ranks (chip_smoke's phase 16d: real
cards where there are N, else N virtual ranks on one card), two solves'
host seconds.  Checks nothing.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SIZES = {"map scale": (1000, 100_000, 300), "pillar": (64, 8192, 1000)}


def _chip_smoke():
    """This checkout's chip_smoke.py (its corridor and profiler helpers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _graph_problem(arrays, ctr_gt):
    """chip_smoke's essential graph: the drifted chain as odometry edges,
    one loop edge from the true relative pose of the last and first
    keyframes, the first keyframe fixed."""
    Rn, tn = arrays[0], arrays[1]
    C = len(Rn)
    Rg = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    tg = -ctr_gt
    ei = np.concatenate([np.arange(C - 1), [C - 1]]).astype(np.int32)
    ej = np.concatenate([np.arange(1, C), [0]]).astype(np.int32)
    Rs = np.concatenate([Rn[1:] @ Rn[:-1].transpose(0, 2, 1),
                         (Rg[0] @ Rg[C - 1].T)[None]])
    ts = np.concatenate([tn[1:] - np.einsum("eij,ej->ei", Rs[:-1], tn[:-1]),
                         (tg[0] - Rs[-1] @ tg[C - 1])[None]])
    fixed = np.zeros(C, bool)
    fixed[0] = True
    return (Rn, tn, np.ones(C, np.float32), fixed, ei, ej, Rs, ts,
            np.ones(C, np.float32), np.ones(C, bool))


def child(tree: str, mesh_n: int) -> None:
    """Time the solvers of the airdos_tpu_torch under `tree`; print one
    JSON line."""
    sys.path.insert(0, tree)
    import torch
    from airdos_tpu_torch.convert import to_device
    from airdos_tpu_torch.parallel import mesh as pmesh
    from airdos_tpu_torch.slam.ba_driver import (pad_edge_table,
                                                 solve_global_ba)
    from airdos_tpu_torch.solvers.pose_graph import optimize_essential_graph
    cs = _chip_smoke()
    out = {}
    for name, (C, P, per_cam) in SIZES.items():
        arrays, cam, ctr_gt, _ = cs._corridor(np.random.default_rng(0), C, P,
                                              per_cam)
        dev = [to_device(a, "cuda") for a in arrays]
        graph = [to_device(a, "cuda",
                           np.float32 if a.dtype.kind == "f" else None)
                 for a in _graph_problem(arrays, ctr_gt)]
        for solver, size, fn in (
                ("global BA", f"E {len(arrays[5])}",
                 lambda: solve_global_ba(*dev, *cam)),
                ("essential graph", f"K {C}",
                 lambda: optimize_essential_graph(*graph))):
            fn()                                  # builds, first launches
            secs, _ = cs._timed_device(fn)
            busy, n_k = cs._busy_ms(fn)
            out[f"{solver}, {name} ({size})"] = dict(s=secs, busy_ms=busy,
                                                     kernels=n_k)
        if mesh_n and name == "map scale":
            if torch.cuda.device_count() < mesh_n:
                os.environ[pmesh.VIRTUAL_DEVICES_ENV] = str(mesh_n)
            mesh = pmesh.make_mesh(mesh_n, "cuda")
            E = len(arrays[5])
            padded = pad_edge_table(*arrays[5:9], -(-E // mesh_n) * mesh_n)
            sharded = [to_device(a, "cuda")
                       for a in tuple(arrays[:5]) + padded[:5]]
            secs, _ = cs._timed_device(
                lambda: solve_global_ba(*sharded, *cam, mesh=mesh))
            out[f"global BA sharded over {mesh.describe()}, {name}"] = \
                dict(s=secs, busy_ms=None, kernels=None)
    print(json.dumps(dict(tree=tree, rows=out)), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a git archive of another commit")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of (parent, change, change, parent)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="ranks of a mesh for the sharded global BA")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child, args.mesh)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    trees = [("change", str(ROOT))]
    if args.parent:
        parent = ("parent", str(Path(args.parent).resolve()))
        trees = [parent, trees[0], trees[0], parent]
    runs = []
    for _ in range(args.rounds):
        for label, tree in trees:
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, __file__, "--child", tree,
                                  "--mesh", str(args.mesh)],
                                 capture_output=True, text=True, cwd=tree)
            if res.returncode != 0:
                sys.exit(f"{label} ({tree}) failed:\n{res.stderr[-4000:]}")
            rows = json.loads(res.stdout.strip().splitlines()[-1])["rows"]
            runs.append((label, rows))
            print(f"[ab] {label} run in {time.perf_counter() - t0:.1f} s",
                  flush=True)
    for key in runs[0][1]:
        for label, rows in runs:
            r = rows[key]
            busy = "" if r["busy_ms"] is None else (
                f", device busy {r['busy_ms']:.2f} ms in {r['kernels']} "
                f"kernels")
            print(f"[ab] {key}, {label}: {[round(x, 4) for x in r['s']]} s a "
                  f"solve{busy}", flush=True)
    print(f"[ab] on {smi}", flush=True)


if __name__ == "__main__":
    main()
