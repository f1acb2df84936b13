"""Observability: structured logging + tracing/profiling.

The reference's only observability is scattered cout prints and the
Pangolin viewer (SURVEY §5).  Here:

- EventLog: structured JSONL event stream (one dict per line) with a
  cheap in-memory ring; used by System / LoopCloser / BA drivers for
  per-frame timings, BA sizes, loop events.
- Profiler: per-stage host timers (median/mean report like the reference's
  stereo_human.cc:148-150 printout) plus optional torch.profiler device
  traces written as Chrome traces (airdos_tpu uses jax.profiler there).
  Online, the tracking thread and the worker threads add spans at once.
- span: context manager timing one stage into a Profiler.

System reads AIRDOS_EVENT_LOG (the JSONL file of its EventLog) and
AIRDOS_TRACE_DIR (the Profiler's trace directory), as airdos_tpu does.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Dict, Optional


class EventLog:
    """Append-only structured events; optionally mirrored to a JSONL file."""

    def __init__(self, path: Optional[str] = None, keep: int = 4096):
        self.path = path
        self._fh = open(path, "a") if path else None
        self.ring = deque(maxlen=keep)
        self._lock = threading.Lock()    # online: emitted from every thread

    def emit(self, event: str, **fields):
        rec = {"t": time.time(), "event": event, **fields}
        with self._lock:
            self.ring.append(rec)
            if self._fh is not None:
                self._fh.write(json.dumps(rec) + "\n")
                self._fh.flush()

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def events(self, event: Optional[str] = None):
        with self._lock:
            ring = list(self.ring)
        return [r for r in ring if event is None or r["event"] == event]

    def __getstate__(self):
        # copy.deepcopy and pickle: the events only (no lock, no file)
        state = dict(self.__dict__)
        state["_lock"] = state["_fh"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()


class Profiler:
    """Per-stage wall-clock accumulation + optional torch.profiler trace."""

    def __init__(self, trace_dir: Optional[str] = None):
        self.stages: Dict[str, list] = defaultdict(list)
        self.trace_dir = trace_dir
        self._lock = threading.Lock()
        self._trace = None               # the running torch.profiler
        self._n_traces = 0

    def __getstate__(self):
        # copy.deepcopy and pickle: the spans only (no lock, no trace)
        state = dict(self.__dict__)
        state["_lock"] = state["_trace"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def add(self, stage: str, seconds: float):
        with self._lock:
            self.stages[stage].append(seconds)

    def start_device_trace(self):
        """Start a torch.profiler trace of the CPU and, where there is a
        card, of its kernels (no-op without a trace directory)."""
        if self.trace_dir and self._trace is None:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._trace = profile(activities=acts)
            self._trace.start()

    def stop_device_trace(self):
        """Stop the trace and write it to trace_dir as a Chrome trace
        (trace_<n>.json); returns its path, or None when none ran."""
        if self._trace is None:
            return None
        self._trace.stop()
        out = Path(self.trace_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"trace_{self._n_traces}.json"
        self._trace.export_chrome_trace(str(path))
        self._trace = None
        self._n_traces += 1
        return path

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        with self._lock:
            items = [(k, list(v)) for k, v in self.stages.items()]
        for stage, ts in items:
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
