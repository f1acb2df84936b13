"""Relocalization's and ComputeSim3's time, this checkout against another,
on the card.

    python3 tools/reloc_loop_ab.py [--parent DIR] [--rounds N] [--online N]

Renders chip_smoke.py's static-28 and pillar-84 frames once, then runs
chip_smoke.py's ``geometry_split`` (this checkout's) on the package of
each checkout in a process of its own: this one and, with --parent, the
one unpacked at DIR (``git archive``), in turns (parent, change, change,
parent by default).  Each run builds its checkout's kernels, drives phase
reloc's blackout and the pillar orbit through Systems whose stages are
timed with a synchronize on both sides, and prints the relocalizing
frame's stages and the ComputeSim3 calls' with their device busy time
(torch.profiler), the spans sim3.* and loop.detect, and the card's name
and power limit.  With --online N each run then feeds the pillar orbit
to the online System back to back N times (chip_smoke.py phase 13a's
run) and prints each run's LOST frames, keyframes and loops closed.
Checks nothing.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    """This checkout's chip_smoke.py; it imports the port lazily, so the
    package it drives is whichever sys.path finds first."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod     # its render pool pickles by name
    spec.loader.exec_module(mod)
    return mod


def worker(checkout: Path, data: Path, online: int) -> None:
    sys.path.insert(0, str(checkout))
    cs = _chip_smoke()
    from airdos_tpu_torch.ops import cuda_build
    assert Path(cuda_build.__file__).is_relative_to(checkout)
    sources = sorted(cuda_build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(cuda_build.build, sources))
    print(f"[ab] {checkout}: {len(sources)} sources built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    with open(data, "rb") as f:
        frames, twc, orbit = pickle.load(f)
    smi = cs._nvidia_smi()
    out = cs.geometry_split(smi, frames, twc, orbit)
    print("[ab-row] " + json.dumps({"checkout": str(checkout), **out}),
          flush=True)
    for i in range(online):
        slam, states, _ = cs._run_online_pillar(orbit, None)
        lc = slam.loop_closer
        print(f"[ab-online] {checkout} run {i}: LOST frames "
              f"{[j for j, s in enumerate(states) if s != 'OK']}, keyframes "
              f"{len(slam.map.kfs)}, loops closed "
              f"{lc.closed if lc else None}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--online", type=int, default=0)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--data", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker.resolve(), args.data, args.online)
        return
    sys.path.insert(0, str(ROOT))
    cs = _chip_smoke()
    frames, twc = cs._bench_frames(cs.N_FRAMES)
    orbit, _ = cs._orbit_frames(cs.N_ORBIT)
    turns = [ROOT] * args.rounds
    if args.parent is not None:
        parent = args.parent.resolve()
        turns = [parent if i % 4 in (0, 3) else ROOT
                 for i in range(args.rounds)]
    print(f"[ab] card: {cs._nvidia_smi()}; turns "
          f"{[str(t) for t in turns]}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "frames.pkl"
        with open(data, "wb") as f:
            pickle.dump((frames, twc, orbit), f)
        for checkout in turns:
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, str(Path(__file__)
                                                      .resolve()),
                                  "--worker", str(checkout), "--data",
                                  str(data), "--online", str(args.online)],
                                 env=dict(os.environ))
            print(f"[ab] {checkout}: exit {res.returncode} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
