"""The online loop stall of the pillar orbit fed live at Camera.fps
(chip_smoke.py's phase 13a, `_run_online_pillar`), run in turns under
several modes on one card, with the worst frames of each run's stall
window taken apart.

    python3 tools/online_stall_ab.py [--runs N] [--modes a,b,...]

Run from the repository root on a CUDA machine (or from another checkout's
root: the tool imports the chip_smoke.py and airdos_tpu_torch/ of the
directory it is run from).  Modes, applied to the whole System:

- ``shipped``: as it is.
- ``no-hook``: the essential graph and the background global BA called
  without their per-step gate waits.
- ``no-gba``: no background global BA after a loop closure.
- ``window-only``: the background global BA's step waits only while the
  tracking thread is in its device window, not for a gap between its
  whole frames.
- ``any-gap``: the step waits for a gap between whole frames, but not
  for one that no earlier step began in.
- ``nice``: the background global BA's thread at nice 19.

``--blocking-sync`` makes the process's CUDA context block on a
synchronization instead of spinning (CU_CTX_SCHED_BLOCKING_SYNC), for
every run of the call.

Each run prints its median frame, p90, worst stall frame and bound, the
loop solvers' spans, the garbage collector's collections over the run,
and for the three slowest frames of the stall window the tracking
thread's wall and CPU time, its own spans, every other thread's spans
that overlapped the frame (ms of overlap) and the collections that did.  The last lines
give each mode's medians over its runs.  It checks nothing.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402

MODES = ("shipped", "no-hook", "no-gba", "window-only", "any-gap", "nice")


@contextlib.contextmanager
def _mode(mode: str):
    """The System as shipped, or with one of MODES' changes."""
    from airdos_tpu_torch.slam import ba_driver, loop_closing
    from airdos_tpu_torch.utils.gate import BACKGROUND_WAIT_S
    shipped = (ba_driver.solve_global_ba,
               loop_closing.optimize_essential_graph, ba_driver.GlobalBA.launch,
               ba_driver.gate_wait, ba_driver.gap_waiter)
    if mode == "no-hook":
        def solve(*args, **kwargs):
            kwargs["gate"] = None
            return shipped[0](*args, **kwargs)

        def graph(*args, **kwargs):
            kwargs.pop("step_hook", None)
            return shipped[1](*args, **kwargs)
        ba_driver.solve_global_ba = solve
        loop_closing.optimize_essential_graph = graph
    elif mode == "no-gba":
        ba_driver.GlobalBA.launch = lambda self, map_lock, n_iters=20: None
    elif mode == "window-only":
        ba_driver.gap_waiter = lambda gate: \
            lambda: shipped[3](gate, BACKGROUND_WAIT_S)
    elif mode == "any-gap":
        ba_driver.gap_waiter = lambda gate: \
            lambda: gate.wait_gap(-1, BACKGROUND_WAIT_S, 0.0)
    elif mode == "nice":
        def waiter(gate):
            hook = shipped[4](gate)

            def wait():
                os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
                hook()
            return wait
        ba_driver.gap_waiter = waiter
    elif mode != "shipped":
        raise SystemExit(f"unknown mode {mode}; modes {MODES}")
    try:
        yield
    finally:
        (ba_driver.solve_global_ba, loop_closing.optimize_essential_graph,
         ba_driver.GlobalBA.launch, ba_driver.gate_wait,
         ba_driver.gap_waiter) = shipped


@contextlib.contextmanager
def _timeline():
    """Record every profiler span as (thread, stage, start, end) on
    time.time(), and each tracking frame's (start, end, CPU s of the
    tracking thread)."""
    from airdos_tpu_torch.slam.system import System
    from airdos_tpu_torch.utils.obs import Profiler
    spans, frames = [], []
    add, track = Profiler.add, System._track

    def timed_add(self, stage, seconds):
        t = time.time()
        spans.append((threading.current_thread().name, stage, t - seconds, t))
        add(self, stage, seconds)

    def timed_track(self, data):
        cpu0 = _thread_cpu()
        w0, c0 = time.time(), time.thread_time()
        try:
            return track(self, data)
        finally:
            w1, c1 = time.time(), time.thread_time()
            cpu = _thread_cpu()
            cpu.subtract(cpu0)
            frames.append((w0, w1, c1 - c0, cpu))
    Profiler.add, System._track = timed_add, timed_track
    try:
        yield spans, frames
    finally:
        Profiler.add, System._track = add, track


def _thread_cpu() -> dict:
    """CPU seconds (user + system) of each of the process's threads, by
    Python thread name ("other" for the threads Python did not start)."""
    names = {t.native_id: t.name for t in threading.enumerate()}
    tick = os.sysconf("SC_CLK_TCK")
    out = collections.Counter()
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        out[names.get(int(tid), "other")] += \
            (int(fields[11]) + int(fields[12])) / tick
    return out


def _blocking_sync():
    """Make the CUDA primary context of device 0 block on a
    synchronization (before the context exists)."""
    import ctypes
    cuda = ctypes.CDLL("libcuda.so.1")
    assert cuda.cuInit(0) == 0
    dev = ctypes.c_int()
    assert cuda.cuDeviceGet(ctypes.byref(dev), 0) == 0
    assert cuda.cuDevicePrimaryCtxSetFlags(dev, 4) == 0   # BLOCKING_SYNC


def _frame_parts(spans, frame) -> str:
    """The tracking thread's spans in a frame and the other threads'
    spans that overlapped it, longest first."""
    w0, w1, cpu, threads = frame
    own, other = collections.Counter(), collections.Counter()
    for th, stage, a, b in spans:
        ov = min(b, w1) - max(a, w0)
        if ov <= 0:
            continue
        if th == "MainThread":
            if stage != "track":
                own[stage] += ov
        else:
            other[f"{th}:{stage}"] += ov
    fmt = lambda c: ", ".join(f"{k} {v * 1e3:.1f}"        # noqa: E731
                              for k, v in c.most_common(8)) or "none"
    return (f"wall {(w1 - w0) * 1e3:.1f} ms, tracking CPU {cpu * 1e3:.1f} "
            f"ms; CPU ms by thread {fmt(threads)}; own spans {fmt(own)}; "
            f"others overlapping {fmt(other)}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--modes", default="shipped,window-only")
    ap.add_argument("--blocking-sync", action="store_true")
    args = ap.parse_args()
    modes = args.modes.split(",")
    if args.blocking_sync:
        _blocking_sync()
    smi = chip_smoke.phase_environment()
    chip_smoke.phase_build()
    orbit, _ = chip_smoke._orbit_frames(chip_smoke.N_ORBIT)
    fps = chip_smoke._loop_config().camera.fps
    order = [m for i in range(args.runs)
             for m in (modes if i % 2 == 0 else modes[::-1])]
    rows = collections.defaultdict(list)
    for k, mode in enumerate(order):
        with _mode(mode), _timeline() as (spans, frames):
            slam, states, st = chip_smoke._run_online_pillar(orbit, fps)
        stages = slam.profiler.stages
        times = st["times"]
        row = dict(med=st["med"] * 1e3,
                   p90=float(np.percentile(times[20:], 90)) * 1e3,
                   worst=(st["worst"] or 0.0) * 1e3, bound=st["bound"] * 1e3,
                   eg=sum(stages.get("loop.essential_graph", [0.0])) * 1e3,
                   gba=sum(stages.get("gba.solve", [0.0])) * 1e3)
        rows[mode].append(row)
        lc = slam.loop_closer
        print(f"[stall-ab] run {k} {mode}: " + ", ".join(
            f"{key} {v:.2f}" for key, v in row.items())
            + f" ms; loops {lc.closed if lc else None}, states "
            f"{dict(collections.Counter(states))}; "
            f"{chip_smoke._mapping_load(st)}; garbage collections "
            f"{st['gc']} on {smi}", flush=True)
        sel = np.flatnonzero(st["sel"])
        for i in sel[np.argsort(times[sel])[::-1][:3]]:
            w0, w1 = frames[i][:2]
            print(f"[stall-ab]   frame {i}: {_frame_parts(spans, frames[i])}"
                  f"; garbage collections {st['gc_log'].within(w1, w1 - w0)}",
                  flush=True)
    for mode in modes:
        r = rows[mode]
        print(f"[stall-ab] {mode}{' blocking-sync' * args.blocking_sync}: medians over {len(r)} runs: worst "
              f"{np.median([x['worst'] for x in r]):.2f} ms, worst / median "
              f"{np.median([x['worst'] / x['med'] for x in r]):.3f}, frame "
              f"median {np.median([x['med'] for x in r]):.2f} ms; runs within "
              f"the bound {sum(x['worst'] < x['bound'] for x in r)}/{len(r)}; "
              f"worst of all {max(x['worst'] for x in r):.2f} ms on {smi}",
              flush=True)


if __name__ == "__main__":
    main()
