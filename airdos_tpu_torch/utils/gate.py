"""Tracking-priority scheduling for online mode: the host gate and the
CUDA streams.

The host half is airdos_tpu/utils/gate.py's ``TrackingGate`` and
``gate_wait``, copied (pure threading).  The tracking thread holds the
gate across its per-frame window (prep, which may wait for the map lock,
-> host pack -> fused step -> result read; airdos_tpu's starts at the
pack), and the mapping, loop and BA workers call ``gate_wait``
right before each of their own dispatches, deferring while tracking is
inside the window.  On a TPU the gate keeps mapping programs out of the
chip's single FIFO; on an H100 the device runs streams concurrently, so
the gate's work here is to keep a worker's Python launch loop out of the
tracking thread's window, which limits their contention for the
interpreter lock.  The wait is bounded (0.25 s), so a stalled tracking
thread cannot deadlock a worker, and it is a no-op unless the System
installs a gate (online mode only).  Beyond airdos_tpu's waits, the loop
closer's essential graph and the background global BA wait at every
Gauss-Newton step: on an NVIDIA H100 80GB HBM3 at 700 W their launch
loops beside the tracking thread's made the worst tracking frame of a
loop closure 4.3 x the median frame, and 1.8 x with the step waits
(medians of two runs each; PERF.md section 6).  The global BA, which no
one waits for, starts each step only in a gap between the tracking
thread's whole frames (``System._track`` inside ``TrackingGate.frame``),
one step a gap (``gap_waiter``): beside the other threads a step's
launch loop took 80-170 ms of CPU, so a second step in the same gap
would run on into the next frame.  Waiting for the device window alone let its steps fill
the rest of every frame, where the keyframe work (``track.kf``, host
bookkeeping under the map lock) then ran 3-4 x its length: on the same
card, pillar-84 live at 5 fps, the worst frame of a loop closure's
stall window was 292.6-510.7 ms that way and 193.0-220.9 ms with a wait
for the whole frame (tools/online_stall_ab.py).  When no frame has
ended for ``BACKGROUND_IDLE_S`` the tracking thread is taken as idle and
a step starts in the same gap.

The interpreter's cyclic garbage collector: a collection holds the
interpreter lock while it scans, and a generation-2 collection scans every
tracked object in the process, so every thread's Python waits for it.
The online System therefore freezes the objects alive when it starts
(``freeze_heap``: the imports, the caller's data, the System's own set-up)
and thaws them at shutdown (``thaw_heap``); a collection in between scans
only what the run made.  On an NVIDIA H100 80GB HBM3 at 700 W, in a
process holding ~560,000 tracked objects, one generation-2 collection
during the pillar orbit live at 5 fps took 491 ms, and one that fell in a
loop closure's window put its tracking frame over the stall bound
(PERF.md section 6).

The device half: online, the tracking thread launches on one stream of
high priority (``TRACKING_PRIORITY``, negative: CUDA schedules its blocks
first) and each worker thread on its own stream of priority 0.  PyTorch's
current stream is thread-local and a new thread starts on the default
stream, so every worker enters its stream at the top of its thread body
(``on_stream``) and System runs ``Tracking.track`` inside the tracking
stream.  Off CUDA, ``new_stream`` gives None and ``on_stream(None)`` is
a null context: the CPU runs online mode on the same threads without
streams, and offline mode stays on the current stream.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Optional

import torch

TRACKING_PRIORITY = -1     # CUDA: a lower number is a higher priority
WORKER_PRIORITY = 0
# the longest a background solve's step waits for a gap between
# tracking's frames: longer than a frame, bounded so that a stalled
# tracking thread cannot hold the solve forever
BACKGROUND_WAIT_S = 2.0
# a gap this long with no frame: tracking is idle (longer than the gap
# between frames at 5 fps, ~140 ms)
BACKGROUND_IDLE_S = 0.25


class TrackingGate:
    def __init__(self, timeout: float = 0.25):
        self._clear = threading.Event()
        self._clear.set()
        self._timeout = timeout
        self._frames = threading.Condition()
        self._in_frame = False
        self._ended = 0                # frames ended
        self._t_end = float("-inf")    # time.monotonic() at the last end

    # ---- tracking side: context manager around the device window -----
    def __enter__(self):
        self._clear.clear()
        return self

    def __exit__(self, *exc):
        self._clear.set()
        return False

    @contextlib.contextmanager
    def frame(self):
        """Tracking side: around the whole frame, the device window
        included."""
        with self._frames:
            self._in_frame = True
        try:
            yield self
        finally:
            with self._frames:
                self._in_frame = False
                self._ended += 1
                self._t_end = time.monotonic()
                self._frames.notify_all()

    # ---- worker side: call right before launching device work --------
    def wait(self, timeout=None):
        self._clear.wait(self._timeout if timeout is None else timeout)

    def wait_gap(self, seen: int, timeout: float, idle: float) -> int:
        """Until the tracking thread is between frames and a frame has
        ended since `seen` (a count this returned before) or none has
        ended for `idle` s; at most `timeout` s.  Returns the count of
        frames ended."""
        deadline = time.monotonic() + timeout
        with self._frames:
            while True:
                now = time.monotonic()
                if not self._in_frame and (self._ended > seen or
                                           now - self._t_end >= idle):
                    break
                if now >= deadline:
                    break
                wake = deadline if self._in_frame else \
                    min(deadline, self._t_end + idle)
                self._frames.wait(wake - now)
            return self._ended


def gate_wait(gate, timeout=None) -> None:
    """Defer a worker-thread dispatch while tracking is in its device
    window, at most `timeout` s (the gate's 0.25 s by default); no-op when
    no gate is installed (offline / single-thread)."""
    if gate is not None:
        gate.wait(timeout)


def gap_waiter(gate, timeout: float = BACKGROUND_WAIT_S,
               idle: float = BACKGROUND_IDLE_S):
    """A background solve's step hook: each call waits for a gap between
    the tracking thread's frames that no earlier call began in (or for
    `idle` s with no frame), at most `timeout` s; None without a gate."""
    if gate is None:
        return None
    seen = [-1]

    def wait():
        seen[0] = gate.wait_gap(seen[0], timeout, idle)
    return wait


_frozen = [0]                  # online Systems holding the heap frozen
_frozen_lock = threading.Lock()


def freeze_heap() -> None:
    """Move every object the garbage collector tracks now out of its
    collections' scans (``gc.freeze``) until the matching ``thaw_heap``;
    the holds nest, so the heap thaws when the last online System shuts
    down."""
    with _frozen_lock:
        _frozen[0] += 1
        gc.freeze()


def thaw_heap() -> None:
    """Release a ``freeze_heap`` hold; the last returns the frozen objects
    to the oldest generation (``gc.unfreeze``)."""
    with _frozen_lock:
        if _frozen[0] == 0:
            return
        _frozen[0] -= 1
        if _frozen[0] == 0:
            gc.unfreeze()


def new_stream(device, priority: int) -> Optional["torch.cuda.Stream"]:
    """A CUDA stream of `priority` on `device`, or None off CUDA."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.Stream(device=device, priority=priority)


def on_stream(stream):
    """Make `stream` the calling thread's current stream for the block
    (a null context for None)."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)
