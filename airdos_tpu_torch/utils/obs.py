"""Observability: structured logging + tracing/profiling.

The reference's only observability is scattered cout prints and the
Pangolin viewer (SURVEY §5).  Here:

- EventLog: structured JSONL event stream (one dict per line) with a
  cheap in-memory ring; used by System / LoopCloser / BA drivers for
  per-frame timings, BA sizes, loop events.
- Profiler: per-stage host timers (median/mean report like the reference's
  stereo_human.cc:148-150 printout).
- span: context manager timing one stage into a Profiler.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict, deque
from typing import Dict, Optional


class EventLog:
    """Append-only structured events; optionally mirrored to a JSONL file."""

    def __init__(self, path: Optional[str] = None, keep: int = 4096):
        self.path = path
        self._fh = open(path, "a") if path else None
        self.ring = deque(maxlen=keep)

    def emit(self, event: str, **fields):
        rec = {"t": time.time(), "event": event, **fields}
        self.ring.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def events(self, event: Optional[str] = None):
        return [r for r in self.ring if event is None or r["event"] == event]


class Profiler:
    """Per-stage wall-clock accumulation."""

    def __init__(self):
        self.stages: Dict[str, list] = defaultdict(list)

    def add(self, stage: str, seconds: float):
        self.stages[stage].append(seconds)

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for stage, ts in self.stages.items():
            s = sorted(ts)
            n = len(s)
            out[stage] = {"n": n, "median_s": s[n // 2],
                          "mean_s": sum(s) / n, "total_s": sum(s)}
        return out

    def summary(self) -> str:
        return "\n".join(
            f"{k:24s} n={v['n']:5d} median={v['median_s'] * 1e3:8.2f}ms "
            f"mean={v['mean_s'] * 1e3:8.2f}ms total={v['total_s']:7.2f}s"
            for k, v in sorted(self.report().items()))


@contextlib.contextmanager
def span(profiler: Optional[Profiler], stage: str):
    if profiler is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        profiler.add(stage, time.perf_counter() - t0)
