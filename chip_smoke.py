"""Smoke test of airdos_tpu_torch on one NVIDIA GPU (sm_90a: H100 / H200).

    python3 chip_smoke.py              # the smoke test
    python3 chip_smoke.py --profile    # where a frame's and a keyframe's time goes

Run from the repository root.  Phases, each of which fails the run:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, whether nvcc is present; a CUDA device is required;
2. build: csrc/hamming.cu and csrc/segment_sum.cu compiled with nvcc for
   sm_90a, both at once (build seconds);
3. slice: tracking only, Tracking(cfg, FrontEnd(cfg, "cuda"), SlamMap(),
   local_mapper=None) (airdos_tpu's tracking-only configuration), over 28
   bench frames of the synthetic world at the reference budget (640x360,
   1500 ORB features, 8 levels): every frame OK, >= 5 keyframes, ATE <
   0.02 m, >= 3 Hamming launches on every fused ("fast") frame;
4. mapping: System(cfg, device="cuda") over the same 28 frames, quantized
   to uint8 as a dataset's PNGs hold them (phase 14a's in-memory twin),
   with the budgets of bench.py's static configuration: every frame OK, >= 5
   keyframes inserted, ATE < 0.02 m, triangulation created points, the
   static BA solved at every keyframe after the third, batched Hamming
   launches on every keyframe frame after the first, 45 segment_sum
   launches per BA solve (3 per Gauss-Newton step);
5. human: the AirDOS flagship on bench.py sections 2-3's crowd scene
   (SyntheticStereoWorld(seed=2, n_points=500, n_humans=10, crowd=True),
   trajectory(27, 0.1, yaw_rate=0.005), humans rendered; the images
   quantized to uint8, the detections as float64, as phase 14b's reader
   gives them, so that the flagship is its in-memory twin): System with
   bench.py's _cfg(True) (masked extraction, stereo human association,
   the human-trajectory BA every Camera.fps = 5 frames, 8 trajectories x
   8 poses), then the polluted static run (no mask, no human layer) on
   the same frames: every flagship frame OK, >= 1 long trajectory
   optimized, a human BA solve at every cadence tick with long
   trajectories, 45 segment_sum launches per static BA solve and 60 per
   human BA solve (4 per Gauss-Newton step), ATE_human < 0.6 ATE_static
   and < 0.03 m; prints both ATEs, the human BA's reduced dimension D, the
   per-frame latency of tracking, keyframe and human-BA frames and the
   median human_ba span;
6. reloc: the blackout of tests/test_relocalization.py at the bench
   budget on the static-28 frames (no new rendering): frames 0-17, three
   all-zero frames, five repeats of frame 17: every frame before the
   blackout OK, LOST during it, OK at the end having relocalized at frame
   >= 21 (BoW candidates -> SearchByBoW -> EPnP RANSAC -> pose LM), a
   Hamming launch in the relocalizing frame, no TUM step > 0.12 m, ATE <
   max(2 x the uninterrupted run's on the same frames, 0.05 m); prints
   the EPnP inliers, the candidates tried and the frame's latency;
7. loop: tests/test_loop_closure.py's pillar orbit (84 frames, Camera.fps
   5, enable_loop_closing) at the bench budget: every frame OK, a loop
   closed with a loop edge, ATE < 0.15 m, and per frame 45 segment_sum
   launches per static BA solve plus 2020 per loop closure (20 for the
   essential graph, one a step; 2000 for the global BA, 100 a step in four
   calls of five steps); prints the loop's (keyframe, candidate, matches,
   loop points), the loop spans and the per-frame latency medians;
8. map scale: the global BA in GlobalBA's schedule over
   tests/test_global_ba.py's corridor at C = 1000 keyframes, P = 100,000
   points, ~300 observations a keyframe, and the essential graph over the
   same 1000 keyframes with one loop edge (D = 7000): every free keyframe
   moves, the global BA cuts the reprojection chi2 a hundredfold (its
   error to the truth is printed: see phase_map_scale), the essential
   graph halves the loop end's error, two card runs bit-equal, 2000 and
   20 segment_sum launches a solve; prints solve times, device busy time
   (torch.profiler) and peak memory;
9. kernel: each kernel against its plain torch version, with per-call
   times of both (CUDA events, median of 20 samples of 10 back-to-back
   calls) and the kernel's device time (CUDA events around a CUDA graph of
   100 launches, each after a 64 MB write that evicts the L2, the writes'
   own time taken off; and back to back, L2 hot; torch.profiler's reading
   too on the first fixed shape, for comparison), its bound (the larger
   of its bytes over 3.35 TB/s and its operations over the card's peak
   rate) and the cold device time's share of it, and at the path's shapes
   one PyTorch library call that computes the same function, timed per
   call the same way and used nowhere in the port (segment_sum:
   index_add_; Hamming: torch.cdist(p=0) on the descriptors unpacked to
   float {0, 1} [.., 256], unpacked outside the timed window):
   - the 2-D Hamming kernel at 1536x1536, 2048x1536 and a ragged
     1500x1337 of random words: exact equality;
   - every kernel at every shape phases 3-8 launched it with, on the
     first inputs the path gave it at that shape (recorded while the paths
     ran): Hamming exact, batched Hamming (triangulation B=4 x 1536x1536,
     fusion B=9 x 2048x1536 at this budget) exact, segment_sum bit-equal
     to its plain version (index_add_) on a CPU copy and two launches
     bit-equal to each other;
10. determinism: two card runs of the mapping System on the small camera
   over 8 frames give byte-identical TUM and KF/MP/Match dumps, and two
   card runs of the human System (small camera, seed 3, 2 humans, masked,
   Camera.fps 3: three human BA solves in 10 frames) byte-identical TUM
   and KF/MP/Match/HMTraj/Motion dumps;
11. loop replay: the first loop phase 7 closed, replayed (compute_sim3 ->
   correct, essential graph and global BA included) from a deep copy of
   the loop closer taken when it ran: two card replays give byte-identical
   KF / MP / Match dumps; a CPU replay agrees on every keyframe within 2e-3
   (R) / 5e-3 m (t), tests/test_torch_loop_system.py's tolerance;
12. agreement: the mapping System on the small camera over 6 frames on the
   CPU (plain versions) and on the card: the same branches and keyframes,
   poses within 5 mm / 1e-3; the human System of phase 7 on the CPU and
   on the card: the same branches and trajectories, cameras within 1e-4
   m, and after the first human BA solve the joints with an inlier
   projection edge within 5e-3 m (the gaps of the other joints and at the
   end of the run are printed: PERF.md says why they are not held);
13. online, run after phase 8 among the path phases (System with
   is_offline=False: tracking in this thread on a high-priority CUDA
   stream, the mapping pass and loop closing in a worker thread, the
   human BA and the global BA in background threads, each worker on its
   own stream of priority 0):
   a. the pillar orbit of phase 7 with frame i + 1 prefetched before
      frame i: the last frame OK, a loop closed, the global BA run in its
      thread, ATE < 0.15 m, and tests/test_loop_stall.py's bound (the
      worst tracking frame stamped within [t_loop - 8 s, t_loop + 2 s],
      frames before 20 left out, below max(3 x median, median + 0.5 s));
      prints the tracking thread's per-frame median and p90 beside phase
      7's, the mapping load (keyframes inserted and refused, and the
      longest mapping queue, over the run and in the stall window, beside
      phase 7's keyframes), the worker's spans and the launches by
      (kernel, thread, stream priority), and fails unless the mapping worker's batched Hamming and
      segment_sum launches went to a stream of lower priority than the
      tracking thread's 2-D Hamming launches;
   b. the crowd flagship of phase 5 online (tests/test_online_human.py):
      >= 2 human BA solves through HumanLocalBA.launch, a trajectory
      optimized, ATE < 0.03 m, nothing raised at shutdown;
   c. the API on the static frames: localization-only mode for frames
      18-27 after 18 mapped frames (no new keyframe or point, every frame
      OK, the last pose within 0.5 m: tests/test_config_flags.py), reset
      and re-initialization twice, the second reset issued while a global
      BA runs, and a prefetched frame bit-equal to the plain upload;
14. drivers, run after phase 13 among the path phases: the dataset
   drivers (python -m airdos_tpu_torch.examples.*) on sequences written
   with the port's PNG writer from the rendered frames quantized to uint8,
   through reference-format settings YAMLs that read back as the phases'
   configurations; every frame read back equal to what was written:
   a. KITTI layout, static-28: stereo_kitti as a subprocess (started
      once static-28 has rendered, so that it overlaps the other scenes'
      rendering; exit 0, 28 KITTI lines) and its main() in this process,
      both byte-identical to phase 4's System, which is fed the same
      uint8 frames as float32 (the in-memory twin);
   b. TartanAir layout, crowd-27 with segmentation, AlphaPose detections,
      track ids and times.txt: stereo_human with a SaveMap dump, its TUM
      byte-identical to phase 5's flagship on the same uint8 frames, the
      five SaveMap files written, ATE < 0.03 m;
   c. EuRoC layout, static-28 frames 0-13, identity rectification:
      stereo_euroc's TUM byte-identical to the in-memory System's; one
      frame rectified with the reference EuRoC.yaml's cam0 distortion;
      the host's PNG decode (Sub- and Paeth-filtered rows) and
      rectification times per 640x360 image;
   d. tools/evaluate on b's TUM against the ground truth as TUM: its ATE
      within 1e-6 m of this script's;
   e. System(use_viewer=True) over 6 static frames keeping overlays, one
      PPM overlay written (chiprun_out/drivers_overlay.ppm);
   prints each driver's per-frame tracking median and p90 and launches;
15. long horizon, run after phase 14 among the path phases:
   tests/test_long_horizon_dynamic.py on the card (110 frames, the small
   camera, seed 2, 10 humans in a crowd the camera drives through), the
   flagship and the naive static run: the flagship OK at the end, ATE <
   0.8 x the naive run's and < 0.05 m, >= 4 trajectories with >= 1
   ending early and >= 1 starting late, and over the optimized long
   trajectories the medians of joint error < 0.5 m, velocity error < 0.6
   and limb-length error < 0.15 m.

Each path's kernel launch counts are set to 0 just before the path is
driven and read just after; launches made to compare a kernel with its
plain version are not counted; the kernels line's launches add up the
mapping, human, reloc, loop, map-scale, online, drivers and long-horizon
paths' counts.  Frames are
rendered in a pool of forked processes before any CUDA context exists.
The last lines are one JSON line listing the kernels, the nvidia-smi
line, and {"ok": true, "device": {...}}.
Exits non-zero, printing no result, on any failure, including when no
CUDA device is present.

With --profile, phases 1-2 run and then phase_profile instead of the rest:
synchronized stage timers over the 28 bench frames (tracking stages per
fused frame, triangulation / fusion / BA solve per keyframe) and a
torch.profiler trace of the last two frames, then the crowd-27 flagship
run's human BA stages (assembly, solve, write-back) and one more solve of
its last window under torch.profiler (device busy time and the kernels
that hold it); it checks nothing and prints no result line.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import io
import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

N_FRAMES = 28
N_CROWD = 27          # bench.py sections 2-3: 7 warm-up + 20 timed frames
N_ORBIT = 84          # tests/test_loop_closure.py's pillar orbit
N_LONG = 110          # tests/test_long_horizon_dynamic.py's crowd
N_GOOD, N_BLANK, N_HOLD = 18, 3, 5    # the relocalization blackout
SEED = 0
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
# kernel name -> {shape: [launches, first inputs]} on the main paths
_PATH: dict = {}
# the render job the pool's forked workers read
_RENDER: dict = {}


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        _fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Milliseconds per call of fn(), warm: the median over reps samples of
    the CUDA-event time of inner back-to-back calls, divided by inner (5
    samples of 2 calls for a call over 2 ms: the plain versions and
    library calls at the batched shapes).  A call whose host side outlasts
    its device work is timed by the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > 2e-3:
        reps, inner = 5, 2
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _graph_ms(fn, n: int = 100, reps: int = 15):
    """Device ms per call of fn, from CUDA events around replays of a
    CUDA graph of n calls (no host launch cost between them): (cold,
    hot).  Cold: each call after a 64 MB write that evicts the 50 MB L2,
    as a caller that streams its inputs from HBM finds them; the graph of
    the writes alone is timed alike and taken off.  Hot: n calls back to
    back, the inputs left in L2.  Medians of reps replays."""
    import torch
    flush = torch.empty(16 * 2 ** 20, dtype=torch.int32, device="cuda")

    def per_call(body):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):       # warm-up before capture
            for _ in range(3):
                body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                body()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / n)
        del graph
        return statistics.median(times)

    flush_ms = per_call(flush.zero_)
    cold = per_call(lambda: (flush.zero_(), fn())) - flush_ms
    return cold, per_call(fn)


def _device_ms(fn, kernel: str = "", reps: int = 20):
    """Mean device time (ms) per call of the kernels whose name holds
    `kernel` (all of fn's kernels by default) over reps calls of fn(),
    from torch.profiler's CUDA trace; None when the trace holds no such
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and kernel in e.name]
    if not evs:
        return None
    return sum(e.time_range.elapsed_us() for e in evs) / reps / 1e3


def _counters():
    from airdos_tpu_torch.ops import hamming_kernels as hk
    from airdos_tpu_torch.ops import segment_kernels as sk
    return hk, sk


def _reset_counts() -> None:
    hk, sk = _counters()
    hk.reset_launches()
    sk.reset_launches()


def _counts() -> dict:
    hk, sk = _counters()
    return {"hamming_matrix": hk.launches(),
            "hamming_matrix_batched": hk.batched_launches(),
            "segment_sum": sk.launches()}


def phase_environment():
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke test needs a "
              "CUDA device and has no CPU fallback")
    smi = _nvidia_smi()
    print(f"[env] gpu: {smi}")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} devices {torch.cuda.device_count()} "
          f"nvcc {shutil.which('nvcc') or 'not on PATH'}", flush=True)
    return smi


def phase_build():
    hk, sk = _counters()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:     # one nvcc per source, at once
        paths = list(pool.map(lambda mod: mod.build(), (hk, sk)))
    print(f"[build] {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def _words(rng, shape):
    import torch
    w = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32)).cuda()


def _path_recording():
    """A context in which every launch of the three kernels is also
    recorded by shape in _PATH, with the first inputs of each shape, so
    that the kernel phase can hold each kernel against its plain version
    on the inputs the main path gave it.  The launch counts are the
    wrappers' own and unchanged."""
    import torch
    hk, sk = _counters()

    def ham_shape(a, b):           # (batch of a, batch of b, n, m)
        return (1, 1) + tuple(a.shape[:1]) + tuple(b.shape[:1])

    def batched_shape(a, b):
        return tuple(a.shape[:1]) + tuple(b.shape[:1]) + \
            tuple(a.shape[1:2]) + tuple(b.shape[1:2])

    def seg_shape(vals, seg):      # (rows, columns, segments)
        return tuple(vals.shape) + (seg.n,)

    targets = ((hk, "hamming_matrix_cuda", "hamming_matrix", ham_shape),
               (hk, "hamming_matrix_batched_cuda", "hamming_matrix_batched",
                batched_shape),
               (sk, "segment_sum_cuda", "segment_sum", seg_shape))
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in targets]

    lock = threading.Lock()         # online phases launch from threads

    def recorder(launch, name, shape_of):
        def record(*args):
            with lock:
                entry = _PATH.setdefault(name, {}).setdefault(
                    shape_of(*args), [0, None])
                entry[0] += 1
                if entry[1] is None:
                    entry[1] = tuple(x.clone() if isinstance(x, torch.Tensor)
                                     else x for x in args)
            return launch(*args)
        return record

    @contextlib.contextmanager
    def recording():
        for (mod, attr, name, shape_of), (_, _, launch) in zip(targets, saved):
            setattr(mod, attr, recorder(launch, name, shape_of))
        try:
            yield
        finally:
            for mod, attr, launch in saved:
                setattr(mod, attr, launch)
    return recording()


def _fmt_shape(name, shape) -> str:
    if name == "segment_sum":
        rows, k, n = shape
        return f"{rows} rows -> {n} x {k}"
    ba, bb, n, m = shape
    if name == "hamming_matrix":
        return f"{n}x{m}"
    return f"B={max(ba, bb)} x {n}x{m} (a {'shared' if ba == 1 else ba})"


def _out_size(name, shape) -> int:
    if name == "segment_sum":
        return shape[1] * shape[2]
    return max(shape[0], shape[1]) * shape[2] * shape[3]


def _check_on_path_inputs(name, args):
    """Holds the kernel against its plain version on one recorded input;
    returns the max abs error and two callables for timing: the kernel and
    its plain version on the card."""
    import torch
    hk, sk = _counters()
    if name == "segment_sum":
        vals, seg = args
        got1 = sk.segment_sum(vals, seg)
        got2 = sk.segment_sum(vals, seg)
        want = sk.segment_sum_ref(vals.cpu(), seg.key.cpu(), seg.n)
        torch.cuda.synchronize()
        err = float((got1.cpu() - want).abs().max())
        if not torch.equal(got1.cpu(), want):
            _fail(f"segment_sum != plain version on the CPU (max abs err "
                  f"{err})")
        if not torch.equal(got1, got2):
            _fail("segment_sum launches differ")
        return err, (lambda: sk.segment_sum(vals, seg)), \
            (lambda: sk.segment_sum_ref(vals, seg.key, seg.n))
    kernel, plain = ((hk.hamming_matrix, hk.hamming_matrix_ref)
                     if name == "hamming_matrix" else
                     (hk.hamming_matrix_batched, hk.hamming_matrix_batched_ref))
    a, b = args
    got, want = kernel(a, b), plain(a, b)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if not torch.equal(got, want):
        _fail(f"{name} != plain version (max abs err {err})")
    return err, (lambda: kernel(a, b)), (lambda: plain(a, b))


# H100 SXM peaks (NVIDIA's data sheet, dense): HBM3 rate, the int8
# tensor-core rate (the table lists no binary rate; a 1-bit AND + popcount
# is counted as two operations against it) and float32 outside the tensor
# cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_FLOPS = 67e12


def _bound(name, shape, args):
    """The least time (ms) the card could take for one call at `shape` on
    these inputs, and what bounds it: the larger of the bytes the function
    must move (each input read once, the output written once) over the HBM
    rate and its operations over the peak rate for their type.  A segment
    sum reads only the rows its segments hold (this run's data)."""
    if name == "segment_sum":
        rows, k, n = shape
        kept = int(args[1].offsets[-1])
        nbytes = 4 * (kept * (k + 1) + (n + 1) + n * k)
        t_ops = kept * k / FP32_FLOPS
    else:
        ba, bb, n, m = shape
        nbytes = 32 * (ba * n + bb * m) + 4 * max(ba, bb) * n * m
        t_ops = 2 * 256 * max(ba, bb) * n * m / INT8_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def _unpack_bits(w):
    """int32 descriptor words [..., 8] -> float32 {0, 1} [..., 256]."""
    import torch
    shifts = torch.arange(32, dtype=torch.int32, device=w.device)
    return ((w[..., None] >> shifts) & 1).flatten(-2).to(torch.float32)


def _library_call(name, args):
    """One PyTorch call that computes the kernel's function on the same
    inputs (never called by the port), with its inputs prepared outside
    the timed call, and its name.  segment_sum: index_add_ into a
    preallocated buffer (the rows keyed n land in its last row); Hamming:
    torch.cdist(p=0), the count of differing bits, on the unpacked
    descriptors."""
    import torch
    if name == "segment_sum":
        vals, seg = args
        acc = torch.zeros((seg.n + 1, vals.shape[1]), dtype=vals.dtype,
                          device=vals.device)
        return (lambda: acc.index_add_(0, seg.key, vals)), "index_add_"
    a, b = args
    if name == "hamming_matrix":
        x, y = _unpack_bits(a), _unpack_bits(b)
    else:
        B = max(a.shape[0], b.shape[0])
        x = _unpack_bits(a).expand(B, -1, -1).contiguous()
        y = _unpack_bits(b).expand(B, -1, -1).contiguous()
    return (lambda: torch.cdist(x, y, p=0)), "cdist(p=0)"


def _fmt_ms(ms) -> str:
    return f"{ms:.4f} ms" if ms is not None else "not measured"


def _share(bound_ms, dev_ms) -> str:
    return f"{bound_ms / dev_ms:.3f}" if dev_ms and dev_ms > 0 \
        else "not measured"


def phase_kernel(smi: str):
    """Each kernel against its plain version: the 2-D Hamming kernel at
    three fixed shapes of random words, then every kernel at every shape
    the main paths launched it with, on the first inputs the path gave it
    at that shape, beside its bound and one library call.  Device times
    come from CUDA events around a CUDA graph of many launches
    (_graph_ms); the first fixed shape is also read by torch.profiler, the
    reading the graph timing supersedes, for comparison.  Returns per
    kernel the max abs err over all checks and the measurements at its
    most launched path shape."""
    import torch
    hk, _ = _counters()
    rng = np.random.default_rng(SEED)
    errs = {}
    for i, (n, m) in enumerate(((1536, 1536), (2048, 1536), (1500, 1337))):
        a, b = _words(rng, (n, 8)), _words(rng, (m, 8))
        got = hk.hamming_matrix(a, b)
        want = hk.hamming_matrix_ref(a, b)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if got.shape != (n, m) or not torch.equal(got, want):
            _fail(f"kernel != plain version at {n}x{m} (max abs err {err})")
        ms = _cuda_ms(lambda: hk.hamming_matrix(a, b))
        plain_ms = _cuda_ms(lambda: hk.hamming_matrix_ref(a, b))
        cold, hot = _graph_ms(lambda: hk.hamming_matrix(a, b))
        prof = ""
        if i == 0:
            prof = (f", torch.profiler (mean of 20) "
                    f"{_fmt_ms(_device_ms(lambda: hk.hamming_matrix(a, b), 'hamming_kernel'))}")
        bound_ms, bound_by, _ = _bound("hamming_matrix", (1, 1, n, m), None)
        print(f"[kernel] hamming {n}x{m} random words: exact; per call kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events, median of "
              f"20 x 10 back-to-back calls); kernel device time (CUDA graph "
              f"of 100) L2 cold {cold:.4f} ms, hot {hot:.4f} ms{prof}; bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}), device share of bound "
              f"{_share(bound_ms, cold)} on {smi}", flush=True)

    out = {}
    for name in ("hamming_matrix", "hamming_matrix_batched", "segment_sum"):
        shapes = _PATH.get(name, {})
        if not shapes:
            _fail(f"{name}: no launch recorded on the main paths")
        # the most launched shape first; ties go to the larger output
        order = sorted(shapes, key=lambda sh: (-shapes[sh][0],
                                               -_out_size(name, sh)))
        for i, shape in enumerate(order):
            n_launch, args = shapes[shape]
            err, kernel, plain = _check_on_path_inputs(name, args)
            errs[name] = max(errs.get(name, err), err)
            library, lib_name = _library_call(name, args)
            ms, plain_ms = _cuda_ms(kernel), _cuda_ms(plain)
            lib_ms = _cuda_ms(library)
            cold, hot = _graph_ms(kernel)
            bound_ms, bound_by, nbytes = _bound(name, shape, args)
            if i == 0:
                out[name] = dict(ms=ms, plain_ms=plain_ms, device_ms=cold,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 library_ms=lib_ms)
            extra = ""
            if name == "segment_sum":
                longest = int(args[1].offsets.diff().max())
                extra = f"; longest segment {longest} rows"
                what = "bit-equal to the CPU plain version, deterministic"
            else:
                what = "exact"
            print(f"[kernel] {name} {_fmt_shape(name, shape)}, {n_launch} "
                  f"launches on the main paths, on the path's inputs: {what}; "
                  f"per call kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library {lib_name} {lib_ms:.4f} ms; kernel device time "
                  f"(CUDA graph of 100) L2 cold {cold:.4f} ms, hot "
                  f"{hot:.4f} ms; bound {bound_ms * 1e3:.2f} us ({bound_by}: "
                  f"{nbytes / 1e6:.3f} MB at 3.35 TB/s), device share of "
                  f"bound {_share(bound_ms, cold)}{extra} on {smi}",
                  flush=True)
    return {name: dict(max_abs_err=errs[name], **row)
            for name, row in out.items()}


def _bench_config():
    """bench.py's _cfg(False): the static reference budget."""
    from airdos_tpu_torch.config import SlamConfig
    from airdos_tpu_torch.io.synthetic import default_camera
    cfg = SlamConfig()
    cfg.camera = default_camera()
    cfg.orb.n_features = 1500
    cfg.orb.n_levels = 8
    cfg.device.max_keypoints = 2048
    cfg.device.max_local_kfs = 8
    cfg.device.max_fixed_kfs = 4
    cfg.device.max_local_points = 2048
    cfg.device.max_ba_edges = 8192
    return cfg


def _small_config():
    """tests/test_system_e2e.py's small_config."""
    from airdos_tpu_torch.config import SlamConfig
    from airdos_tpu_torch.io.synthetic import small_camera
    cfg = SlamConfig()
    cfg.camera = small_camera()
    cfg.orb.n_features = 600
    cfg.orb.n_levels = 4
    cfg.device.max_keypoints = 1024
    cfg.device.max_local_kfs = 8
    cfg.device.max_fixed_kfs = 4
    cfg.device.max_local_points = 1024
    cfg.device.max_ba_edges = 4096
    return cfg


def _human_bench_config():
    """bench.py's _cfg(True): the flagship's budgets, offline."""
    cfg = _bench_config()
    cfg.human.ok = True
    cfg.human.is_seg = True
    cfg.system.is_mask = True
    cfg.camera.fps = 5.0
    cfg.device.max_trajectories = 8
    cfg.device.max_trajectory_len = 8
    return cfg


def _polluted_config():
    """bench.py's cfg_polluted: the static pipeline, no mask, on the crowd
    frames."""
    cfg = _bench_config()
    cfg.camera.fps = 5.0
    return cfg


def _small_human_config():
    """The human System of tests/test_torch_human_system.py: the small
    camera, masked, Camera.fps 3 (a human BA every 3 frames)."""
    cfg = _small_config()
    cfg.human.ok = True
    cfg.human.is_seg = True
    cfg.system.is_mask = True
    cfg.camera.fps = 3.0
    cfg.device.max_trajectories = 2
    cfg.device.max_trajectory_len = 16
    return cfg


def _small_human_frames(n: int):
    from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
    world = SyntheticStereoWorld(seed=3, n_points=200,
                                 cam=_small_human_config().camera, n_humans=2)
    return [d for d, _, _ in world.sequence(n, dt=0.1, yaw_rate=0.008)]


def _crowd_frames(n: int):
    """bench.py sections 2-3's crowd scene at 640x360 with the humans
    rendered, and its ground truth camera centres."""
    from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
    t0 = time.perf_counter()
    world = SyntheticStereoWorld(seed=2, n_points=500, n_humans=10,
                                 crowd=True)
    Rwc, twc = world.trajectory(n, 0.1, yaw_rate=0.005)
    frames = _render(world, Rwc, twc, 0.1, True)
    print(f"[frames] rendered {n} crowd frames 640x360 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return frames, twc


def _render_one(i):
    world, Rwc, twc, dt, humans = _RENDER["job"]
    return world.frame(i, Rwc[i], twc[i], i * dt, with_humans=humans)


def _render(world, Rwc, twc, dt, humans):
    """Render every pose of a trajectory in a pool of forked processes
    (numpy only; started before any CUDA context exists, and stopped on
    return)."""
    _RENDER["job"] = (world, Rwc, twc, dt, humans)
    n_proc = max(1, min(8, os.cpu_count() or 1))
    with multiprocessing.get_context("fork").Pool(n_proc) as pool:
        frames = pool.map(_render_one, range(len(Rwc)))
    _RENDER.clear()
    return frames


def _small_frames(n: int):
    from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
    cfg = _small_config()
    world = SyntheticStereoWorld(seed=SEED, n_points=200, cam=cfg.camera)
    return [d for d, _, _ in world.sequence(n, dt=0.1, yaw_rate=0.008)]


def _bench_frames(n: int):
    """bench.py section 1's static frames at 640x360, and their ground
    truth camera centres."""
    from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
    t0 = time.perf_counter()
    world = SyntheticStereoWorld(seed=SEED, n_points=500)
    Rwc, twc = world.trajectory(n, 0.1, speed=0.3, yaw_rate=0.005)
    frames = _render(world, Rwc, twc, 0.1, False)
    print(f"[frames] rendered {n} frames 640x360 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return frames, twc


def _orbit_frames(n: int):
    """tests/test_loop_closure.py's pillar orbit at 640x360: the camera
    circles a textured octagonal pillar 1.22 times."""
    from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
    t0 = time.perf_counter()
    world = SyntheticStereoWorld(
        seed=1, n_points=300, centered=True, world_size=(16.0, 3.0, 16.0),
        clear_ring=(1.35, 0.0, 1.35, 0.7), ring_outside_only=True,
        room_radius=4.5, pillar=(1.35, 0.0, 0.55, 8))
    Rwc, twc = world.orbit_loop_trajectory(n, radius=1.35, laps=1.22)
    frames = _render(world, Rwc, twc, 0.2, False)
    print(f"[frames] rendered {n} pillar-orbit frames 640x360 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return frames, twc


def _sync() -> None:
    import torch
    torch.cuda.synchronize()


def _run(slam, frames):
    """Track frames with a System; per frame (state, branch, seconds)."""
    per = []
    track = slam.track_stereo_human if slam.config.human.ok \
        else slam.track_stereo
    for data in frames:
        t0 = time.perf_counter()
        track(data)
        _sync()
        per.append((slam.tracking.state.name, slam.tracking.last_branch,
                    time.perf_counter() - t0))
    slam.shutdown()
    return per


def _ate(trk, twc):
    from airdos_tpu_torch.io.tum import ate_rmse
    _, R_est, t_est = trk.trajectory_tum()
    if t_est.shape != (len(twc), 3) or not np.isfinite(t_est).all() \
            or not np.isfinite(R_est).all():
        _fail(f"trajectory shape {t_est.shape} or non-finite poses")
    return ate_rmse(t_est, twc[:len(t_est)])


def _ms_stats(ms) -> str:
    ms = np.asarray(ms)
    if not len(ms):
        return "none"
    return f"median {np.median(ms):.2f} p90 {np.percentile(ms, 90):.2f}"


def phase_slice(smi: str, frames, twc):
    """Tracking only: airdos_tpu's Tracking(..., local_mapper=None)."""
    from airdos_tpu_torch.slam.frame import FrontEnd
    from airdos_tpu_torch.slam.map import SlamMap
    from airdos_tpu_torch.slam.tracking import Tracking
    from airdos_tpu_torch.utils.obs import Profiler

    cfg = _bench_config()
    trk = Tracking(cfg, FrontEnd(cfg, device="cuda"), SlamMap(),
                   local_mapper=None)
    trk.profiler = Profiler()
    per = []
    _reset_counts()
    for data in frames:
        before = _counts()["hamming_matrix"]
        t0 = time.perf_counter()
        trk.track(data)
        _sync()
        dt = time.perf_counter() - t0
        per.append((trk.state.name, trk.last_branch, dt,
                    _counts()["hamming_matrix"] - before))
    counts = _counts()
    for i, (state, branch, dt, n_launch) in enumerate(per):
        print(f"[slice] frame {i:2d} {state} {branch:5s} {dt * 1e3:9.2f} ms "
              f"hamming launches {n_launch}")
    bad = [i for i, p in enumerate(per) if p[0] != "OK"]
    if bad:
        _fail(f"tracking-only frames not OK: {bad}")
    fast = [p for p in per if p[1] == "fast"]
    if not fast:
        _fail("no frame took the fused (fast) branch")
    few = [i for i, p in enumerate(per) if p[1] == "fast" and p[3] < 3]
    if few:
        _fail(f"fast frames with < 3 Hamming kernel launches: {few}")
    n_kfs = trk.map.n_keyframes()
    if n_kfs < 5:
        _fail(f"tracking only: {n_kfs} keyframes")
    ate = _ate(trk, twc)
    if not ate < 0.02:
        _fail(f"tracking only: ATE {ate} m >= 0.02 m")
    branches = [p[1] for p in per]
    print(f"[slice] branches {branches[0]} -> {branches[1]} -> "
          f"fast x{branches.count('fast')}; keyframes {n_kfs}; map points "
          f"{trk.map.n_points()}; ATE {ate:.6f} m; launches {counts}")
    print(f"[slice] per-frame ms all frames: "
          f"{_ms_stats([p[2] * 1e3 for p in per])}; fast frames: "
          f"{_ms_stats([p[2] * 1e3 for p in fast])} on {smi}", flush=True)
    stages = trk.profiler.report()
    print("[slice] host stages (median ms): " + ", ".join(
        f"{k} {v['median_s'] * 1e3:.2f}" for k, v in sorted(stages.items())))
    return counts


def _trajectory_bytes(slam, kind: str) -> bytes:
    """The bytes of a System's trajectory file, KITTI or TUM."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "traj.txt"
        (slam.save_trajectory_kitti if kind == "kitti"
         else slam.save_trajectory_tum)(path)
        return path.read_bytes()


def phase_mapping(smi: str, frames, twc, twins):
    """The offline System with the mapping pass at the bench budgets; its
    KITTI trajectory goes to twins["kitti"], the in-memory twin of phase
    14a's KITTI driver."""
    from airdos_tpu_torch.slam.system import System

    slam = System(_bench_config(), device="cuda")
    per = []
    _reset_counts()
    for data in frames:
        c0, s0 = _counts(), slam.static_ba.n_solves
        live0 = slam.map.n_keyframes()
        t0 = time.perf_counter()
        slam.track_stereo(data)
        _sync()
        dt = time.perf_counter() - t0
        c1 = _counts()
        kf = slam.map.kfs.get(slam.tracking.last_kf_id)
        is_kf = kf is not None and kf.frame_id == data.index
        per.append(dict(state=slam.tracking.state.name,
                        branch=slam.tracking.last_branch, ms=dt * 1e3,
                        kf=is_kf, live0=live0,
                        solves=slam.static_ba.n_solves - s0,
                        d={k: c1[k] - c0[k] for k in c1}))
    counts = _counts()
    slam.shutdown()
    twins["kitti"] = _trajectory_bytes(slam, "kitti")
    for i, p in enumerate(per):
        print(f"[mapping] frame {i:2d} {p['state']} {p['branch']:5s} "
              f"{'KF' if p['kf'] else '  '} {p['ms']:9.2f} ms BA solves "
              f"{p['solves']} launches {p['d']}")
    bad = [i for i, p in enumerate(per) if p["state"] != "OK"]
    if bad:
        _fail(f"mapping frames not OK: {bad}")
    kf_frames = [i for i, p in enumerate(per) if p["kf"]]
    n_inserted = len(slam.map.kfs)
    if n_inserted < 5:
        _fail(f"mapping: only {n_inserted} keyframes inserted")
    ate = _ate(slam.tracking, twc)
    if not ate < 0.02:
        _fail(f"mapping: ATE {ate} m >= 0.02 m")
    n_created = slam.local_mapper.triangulator.n_created
    if n_created <= 0:
        _fail("mapping: triangulation created no map points")
    no_ba = [i for i in kf_frames if per[i]["live0"] >= 2
             and per[i]["solves"] != 1]
    if no_ba:
        _fail(f"mapping: no static BA solve at keyframe frames {no_ba}")
    no_batched = [i for i in kf_frames[1:]
                  if per[i]["d"]["hamming_matrix_batched"] < 1]
    if no_batched:
        _fail(f"mapping: no batched Hamming launch at keyframe frames "
              f"{no_batched}")
    seg_off = [i for i, p in enumerate(per)
               if p["d"]["segment_sum"] != 45 * p["solves"]]
    if seg_off:
        _fail(f"mapping: segment_sum launches != 45 per BA solve at frames "
              f"{seg_off}")
    idle = [k for k, v in counts.items() if v <= 0]
    if idle:
        _fail(f"mapping: kernels never launched on the main path: {idle}")
    track_ms = [p["ms"] for p in per if not p["kf"]]
    kf_ms = [p["ms"] for i, p in enumerate(per) if p["kf"] and i > 0]
    print(f"[mapping] keyframes inserted {n_inserted} (frames {kf_frames}), "
          f"live {slam.map.n_keyframes()}; map points {slam.map.n_points()}; "
          f"triangulated {n_created}; BA solves {slam.static_ba.n_solves}; "
          f"ATE {ate:.6f} m; launches {counts}")
    print(f"[mapping] per-frame ms tracking frames: {_ms_stats(track_ms)}; "
          f"keyframe frames after the first: {_ms_stats(kf_ms)} on {smi}",
          flush=True)
    stages = slam.profiler.report()
    print("[mapping] spans (median ms): " + ", ".join(
        f"{k} {v['median_s'] * 1e3:.2f} (n {v['n']})"
        for k, v in sorted(stages.items())
        if k.startswith("map.") or k.startswith("ba.")), flush=True)
    return counts


def _reduced_dim(args) -> int:
    """The human BA's reduced dimension from its arguments: 6 C + 3 T L 14
    + 14 T + 6 T (cameras, joints, limb lengths, motions)."""
    C = args[0].shape[0]
    T, L = args[10].shape[:2]
    return 6 * C + 42 * T * L + 20 * T


def phase_human(smi: str, frames, twc, twins):
    """The flagship System (bench.py _cfg(True), offline) and the polluted
    static System on the crowd frames; the flagship's TUM trajectory goes
    to twins["tartanair"], the in-memory twin of phase 14b's driver."""
    from airdos_tpu_torch.slam import ba_driver
    from airdos_tpu_torch.slam.system import System

    dims = []
    solver = ba_driver.human_bundle_adjust

    def recorded(*args, **kwargs):
        dims.append(_reduced_dim(args))
        return solver(*args, **kwargs)

    slam = System(_human_bench_config(), device="cuda")
    per = []
    ba_driver.human_bundle_adjust = recorded
    try:
        _reset_counts()
        for data in frames:
            c0, s0 = _counts(), slam.static_ba.n_solves
            h0, tick0 = slam.human_ba.n_runs, slam._last_human_ba_frame
            t0 = time.perf_counter()
            slam.track_stereo_human(data)
            _sync()
            dt = time.perf_counter() - t0
            c1 = _counts()
            kf = slam.map.kfs.get(slam.tracking.last_kf_id)
            per.append(dict(state=slam.tracking.state.name,
                            branch=slam.tracking.last_branch, ms=dt * 1e3,
                            kf=kf is not None and kf.frame_id == data.index,
                            static=slam.static_ba.n_solves - s0,
                            human=slam.human_ba.n_runs - h0,
                            tick=slam._last_human_ba_frame != tick0,
                            humans=len(slam.tracking.last_frame.humans),
                            d={k: c1[k] - c0[k] for k in c1}))
        counts = _counts()
    finally:
        ba_driver.human_bundle_adjust = solver
    slam.shutdown()
    twins["tartanair"] = _trajectory_bytes(slam, "tum")
    for i, p in enumerate(per):
        print(f"[human] frame {i:2d} {p['state']} {p['branch']:5s} "
              f"{'KF' if p['kf'] else '  '} {'HBA' if p['human'] else '   '} "
              f"{p['ms']:9.2f} ms humans {p['humans']} BA solves static "
              f"{p['static']} human {p['human']} launches {p['d']}")
    bad = [i for i, p in enumerate(per) if p["state"] != "OK"]
    if bad:
        _fail(f"human: flagship frames not OK: {bad}")
    n_opt = sum(t.optimized for t in slam.map.trajectories.values())
    if n_opt < 1:
        _fail("human: no long trajectory optimized")
    missed = [i for i, p in enumerate(per) if p["tick"] and p["human"] != 1]
    if missed or not any(p["tick"] for p in per):
        _fail(f"human: no human BA solve at cadence ticks {missed}")
    seg_off = [i for i, p in enumerate(per) if p["d"]["segment_sum"]
               != 45 * p["static"] + 60 * p["human"]]
    if seg_off:
        _fail(f"human: segment_sum launches != 45 per static and 60 per "
              f"human BA solve at frames {seg_off}")
    idle = [k for k, v in counts.items() if v <= 0]
    if idle:
        _fail(f"human: kernels never launched on the main path: {idle}")
    ate_human = _ate(slam.tracking, twc)
    spans = slam.profiler.report()

    static = System(_polluted_config(), device="cuda")
    _run(static, frames)
    ate_static = _ate(static.tracking, twc)
    print(f"[human] crowd-{len(frames)}: flagship ATE {ate_human:.6f} m, "
          f"polluted static ATE {ate_static:.6f} m (ratio "
          f"{ate_human / ate_static:.3f}); keyframes {len(slam.map.kfs)}, "
          f"trajectories {len(slam.map.trajectories)} ({n_opt} optimized), "
          f"human BA solves {slam.human_ba.n_runs}, reduced dimension D "
          f"{sorted(set(dims))}; launches {counts}")
    if not (ate_human < 0.6 * ate_static and ate_human < 0.03):
        _fail(f"human: flagship ATE {ate_human} m vs static {ate_static} m "
              f"(needs < 0.6x and < 0.03 m)")
    hba = [p["ms"] for p in per if p["human"]]
    kf_ms = [p["ms"] for i, p in enumerate(per)
             if p["kf"] and not p["human"] and i > 0]
    track_ms = [p["ms"] for p in per if not p["kf"] and not p["human"]]
    print(f"[human] per-frame ms tracking frames: {_ms_stats(track_ms)}; "
          f"keyframe frames after the first: {_ms_stats(kf_ms)}; human-BA "
          f"frames: {_ms_stats(hba)} on {smi}")
    print("[human] spans (median ms): " + ", ".join(
        f"{k} {v['median_s'] * 1e3:.2f} (n {v['n']})"
        for k, v in sorted(spans.items())
        if k.startswith(("human_ba", "hba.", "map.static_ba", "track.step"))),
        flush=True)
    return counts


def _reloc_frames(frames, twc, blank: bool):
    """The static-28 frames 0..17, then N_BLANK all-zero frames (or frame
    17 again when blank is False) and N_HOLD repeats of frame 17: the
    camera pauses at its last pose through the blackout (no new
    rendering).  Returns the frames and their ground-truth centres."""
    last = frames[N_GOOD - 1]
    out = list(frames[:N_GOOD])
    for i in range(N_GOOD, N_GOOD + N_BLANK + N_HOLD):
        f = dataclasses.replace(last, index=i, timestamp=i * 0.1)
        if blank and i < N_GOOD + N_BLANK:
            f = dataclasses.replace(
                f, image_left=np.zeros_like(last.image_left),
                image_right=np.zeros_like(last.image_right))
        out.append(f)
    gt = np.concatenate([twc[:N_GOOD],
                         np.repeat(twc[N_GOOD - 1:N_GOOD], N_BLANK + N_HOLD,
                                   axis=0)])
    return out, gt


def phase_reloc(smi: str, frames, twc):
    """Relocalization at the bench budget: the blackout of
    tests/test_relocalization.py on the static-28 frames."""
    from airdos_tpu_torch.io.tum import ate_rmse
    from airdos_tpu_torch.slam.system import System

    cut, gt = _reloc_frames(frames, twc, blank=True)
    slam = System(_bench_config(), device="cuda")
    per = []
    _reset_counts()
    for data in cut:
        c0 = _counts()
        t0 = time.perf_counter()
        slam.track_stereo(data)
        _sync()
        dt = time.perf_counter() - t0
        c1 = _counts()
        per.append(dict(state=slam.tracking.state.name,
                        branch=slam.tracking.last_branch, ms=dt * 1e3,
                        ref=slam.tracking.last_frame.ref_kf_id,
                        d={k: c1[k] - c0[k] for k in c1}))
    counts = _counts()
    trk = slam.tracking
    for i, p in enumerate(per):
        print(f"[reloc] frame {i:2d} {p['state']:4s} {p['branch']:5s} "
              f"{p['ms']:9.2f} ms launches {p['d']}")
    if any(p["state"] != "OK" for p in per[:N_GOOD]):
        _fail(f"reloc: frames before the blackout not OK: "
              f"{[p['state'] for p in per[:N_GOOD]]}")
    if any(p["state"] != "LOST" for p in per[N_GOOD:N_GOOD + N_BLANK]):
        _fail("reloc: tracking not LOST during the blackout")
    if per[-1]["state"] != "OK" or trk.last_reloc_frame < N_GOOD + N_BLANK:
        _fail(f"reloc: state {per[-1]['state']} at the end, relocalized at "
              f"frame {trk.last_reloc_frame}")
    _, _, t_cut = trk.trajectory_tum()
    steps = np.linalg.norm(np.diff(t_cut, axis=0), axis=1)
    if not steps.max() < 0.12:
        _fail(f"reloc: a TUM step of {steps.max()} m")
    reloc_i = int(trk.last_reloc_frame)
    if per[reloc_i]["branch"] != "reloc" or \
            per[reloc_i]["d"]["hamming_matrix"] <= 0:
        _fail(f"reloc: frame {reloc_i} relocalized without a Hamming launch")
    ate_cut = float(ate_rmse(t_cut, gt[:len(t_cut)]))
    full_frames, _ = _reloc_frames(frames, twc, blank=False)
    full = System(_bench_config(), device="cuda")
    _run(full, full_frames)
    _, _, t_full = full.tracking.trajectory_tum()
    ate_full = float(ate_rmse(t_full, gt[:len(t_full)]))
    if not ate_cut < max(2.0 * ate_full, 0.05):
        _fail(f"reloc: ATE {ate_cut} m vs the uninterrupted {ate_full} m")
    print(f"[reloc] relocalized at frame {reloc_i} against keyframe "
          f"{per[reloc_i]['ref']}: {trk.reloc_tried} candidates tried, "
          f"EPnP RANSAC inliers {trk.reloc_inliers}, frame latency "
          f"{per[reloc_i]['ms']:.2f} ms; max TUM step {steps.max():.4f} m; "
          f"ATE {ate_cut:.6f} m (uninterrupted {ate_full:.6f} m); launches "
          f"{counts} on {smi}", flush=True)
    return counts


def _loop_config():
    """The pillar orbit at the bench budget: Camera.fps 5, loop closing."""
    cfg = _bench_config()
    cfg.camera.fps = 5.0
    cfg.enable_loop_closing = True
    return cfg


def _dump_map(m, sigma2) -> bytes:
    """KF / MP / Match lines of System.before_end for a map."""
    out = []
    for kf in sorted(m.kfs.values(), key=lambda k: k.id):
        if not kf.bad:
            out.append(f"{kf.id} " + " ".join(
                f"{v:.7f}" for v in np.concatenate([kf.Ow, kf.Rcw.ravel()])))
    pt = m.points
    for pid in pt.live_ids():
        p = pt.pos[pid]
        out.append(f"{pid} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f}")
        for kf_id, fid in pt.obs[pid].items():
            kf = m.kfs.get(kf_id)
            if kf is not None and not kf.bad:
                u, v = kf.xy_un[fid]
                out.append(f"{pid} {kf_id} {u:.3f} {v:.3f} "
                           f"{kf.u_right[fid]:.3f} "
                           f"{1.0 / sigma2[kf.octave[fid]]:.5f}")
    return "\n".join(out).encode()


def phase_loop(smi: str, frames, twc):
    """The pillar orbit through the offline System with loop closing at
    the bench budget.  Returns the launch counts and, for the loop it
    closed first, a deep copy of the loop closer (map, database, fuser and
    global BA with it) as compute_sim3 found it, with the keyframe and
    candidate."""
    from airdos_tpu_torch.slam import loop_closing
    from airdos_tpu_torch.slam.system import System

    slam = System(_loop_config(), device="cuda")
    snaps = []
    real_sim3 = loop_closing.LoopCloser.compute_sim3
    real_correct = loop_closing.LoopCloser.correct

    def compute_sim3(self, kf, cand_id):
        # the generator's state before this call's RANSAC draws
        self._rng_before = copy.deepcopy(self.rng.bit_generator.state)
        return real_sim3(self, kf, cand_id)

    def correct(self, kf, res):
        # compute_sim3 reads the map and only the correction writes it:
        # a copy here, with the generator put back, replays both
        if not snaps:
            t0 = time.perf_counter()
            snap = copy.deepcopy(self)
            snap.rng.bit_generator.state = self._rng_before
            snaps.append((snap, kf.id, res[4], time.perf_counter() - t0))
        return real_correct(self, kf, res)

    per = []
    loop_closing.LoopCloser.compute_sim3 = compute_sim3
    loop_closing.LoopCloser.correct = correct
    try:
        _reset_counts()
        for data in frames:
            c0, s0 = _counts(), slam.static_ba.n_solves
            g0 = slam.global_ba.n_runs
            lc = slam.loop_closer
            n0 = lc.n_loops_closed if lc is not None else 0
            n_snap = len(snaps)
            t0 = time.perf_counter()
            slam.track_stereo(data)
            _sync()
            # less the snapshot's deep copy, which is not the port's work
            dt = time.perf_counter() - t0 - sum(
                sn[3] for sn in snaps[n_snap:])
            c1 = _counts()
            lc = slam.loop_closer
            kf = slam.map.kfs.get(slam.tracking.last_kf_id)
            per.append(dict(state=slam.tracking.state.name,
                            branch=slam.tracking.last_branch, ms=dt * 1e3,
                            kf=kf is not None and kf.frame_id == data.index,
                            static=slam.static_ba.n_solves - s0,
                            gba=slam.global_ba.n_runs - g0,
                            loops=(lc.n_loops_closed if lc else 0) - n0,
                            d={k: c1[k] - c0[k] for k in c1}))
        counts = _counts()
    finally:
        loop_closing.LoopCloser.compute_sim3 = real_sim3
        loop_closing.LoopCloser.correct = real_correct
    for i, p in enumerate(per):
        print(f"[loop] frame {i:2d} {p['state']} {p['branch']:5s} "
              f"{'KF' if p['kf'] else '  '} {'LOOP' if p['loops'] else '    '}"
              f" {p['ms']:9.2f} ms BA solves {p['static']} launches {p['d']}")
    bad = [i for i, p in enumerate(per) if p["state"] != "OK"]
    if bad:
        _fail(f"loop: frames not OK: {bad}")
    lc = slam.loop_closer
    if lc is None or lc.n_loops_closed < 1 or not snaps:
        _fail("loop: no loop closed")
    if not any(k.loop_edges for k in slam.map.kfs.values()):
        _fail("loop: no loop edge")
    ate = _ate(slam.tracking, twc)
    if not ate < 0.15:
        _fail(f"loop: ATE {ate} m >= 0.15 m")
    per_loop = 20 + 2000                 # essential graph + global BA
    seg_off = [i for i, p in enumerate(per) if p["d"]["segment_sum"]
               != 45 * p["static"] + per_loop * p["loops"]]
    if seg_off:
        _fail(f"loop: segment_sum launches != 45 per static BA solve + "
              f"{per_loop} per loop closure at frames {seg_off}")
    if slam.global_ba.n_runs != lc.n_loops_closed:
        _fail("loop: not one global BA per loop closure")
    loop_frames = [i for i, p in enumerate(per) if p["loops"]]
    if any(per[i]["d"]["hamming_matrix"] <= 0 or
           per[i]["d"]["hamming_matrix_batched"] <= 0 for i in loop_frames):
        _fail("loop: a loop frame launched no 2-D or batched Hamming kernel")
    spans = slam.profiler.report()
    track_ms = [p["ms"] for p in per if not p["kf"]]
    kf_ms = [p["ms"] for i, p in enumerate(per)
             if p["kf"] and not p["loops"] and i > 0]
    print(f"[loop] pillar orbit {len(frames)} frames: loops closed "
          f"{lc.closed} (keyframe, candidate, matches, loop points); "
          f"keyframes {slam.map.n_keyframes()} live; map points "
          f"{slam.map.n_points()}; ATE {ate:.6f} m; loop frames "
          f"{loop_frames} at {[round(per[i]['ms'], 2) for i in loop_frames]}"
          f" ms; launches {counts}")
    print(f"[loop] per-frame ms tracking frames: {_ms_stats(track_ms)}; "
          f"keyframe frames without a loop: {_ms_stats(kf_ms)} on {smi}")
    print("[loop] spans (median ms): " + ", ".join(
        f"{k} {v['median_s'] * 1e3:.2f} (n {v['n']}, max "
        f"{max(slam.profiler.stages[k]) * 1e3:.2f})"
        for k, v in sorted(spans.items())
        if k.startswith(("map.loop_closing", "loop.", "sim3.", "gba.",
                         "map.static_ba", "track.step"))), flush=True)
    return counts, snaps[0][:3], slam.frontend.extractor, \
        dict(track_ms=track_ms, all_ms=[p["ms"] for p in per],
             loop_ms=[per[i]["ms"] for i in loop_frames],
             n_kfs=slam.map.next_kf_id)


def _frame_events(slam):
    """The online System's per-frame host times (s) and stamps from its
    event log, and the stamps of its loop closures."""
    frames = slam.events.events("frame")
    loops = slam.events.events("loop_closed")
    return (np.asarray([f["track_s"] for f in frames]),
            np.asarray([f["t"] for f in frames]),
            [ev["t"] for ev in loops])


def _stall_window(times, stamps, loop_stamps, skip: int = 20):
    """tests/test_loop_stall.py's window: which tracking frames are stamped
    in [t_loop - 8 s, t_loop + 2 s] of a loop closure, the first `skip`
    frames left out."""
    sel = np.zeros(len(times), bool)
    for t in loop_stamps:
        sel |= (stamps > t - 8.0) & (stamps < t + 2.0)
    sel[:skip] = False
    return sel


def _tally():
    hk, sk = _counters()
    return {**hk.launch_tally(), **sk.launch_tally()}


def phase_online(smi: str, orbit, orbit_twc, crowd, crowd_twc, frames, twc,
                 offline_loop):
    """Online mode (is_offline=False): the pillar orbit with loop closing
    and the crowd flagship, then the rest of System's API on the static
    frames.  Returns the launch counts."""
    _reset_counts()
    _online_pillar(smi, orbit, orbit_twc, offline_loop)
    _online_human(smi, crowd, crowd_twc)
    _online_api(frames, twc)
    return _counts()


def _run_online_pillar(orbit):
    """The pillar orbit through the online System at the bench budget,
    frame i + 1 prefetched before frame i.  Returns the System (shut
    down), each frame's state, and tests/test_loop_stall.py's numbers: the
    tracking thread's per-frame host times (s), their median after frame
    20, the stall window's mask, its worst frame (or None) and the bound
    max(3 x median, median + 0.5 s); and per frame the mapping load: the
    keyframes it inserted, whether the busy branch of
    Tracking._need_new_keyframe refused one (mapping busy and >= 3
    keyframes queued), and the queue's length at the frame's end."""
    from airdos_tpu_torch.slam.system import System
    cfg = _loop_config()
    cfg.system.is_offline = False
    slam = System(cfg, device="cuda")
    trk = slam.tracking
    queue_len, refused = trk.mapping_queue_len_fn, [0]

    def read_queue():        # read only when a keyframe is due while busy
        n = queue_len()
        refused[0] += n >= 3
        return n
    trk.mapping_queue_len_fn = read_queue
    states, load = [], []
    for i, data in enumerate(orbit):
        if i + 1 < len(orbit):
            slam.prefetch(orbit[i + 1])
        k0, r0 = slam.map.next_kf_id, refused[0]
        slam.track_stereo(data)
        states.append(trk.state.name)
        load.append((slam.map.next_kf_id - k0, refused[0] - r0,
                     queue_len()))
    slam.shutdown()
    times, stamps, loop_stamps = _frame_events(slam)
    med = float(np.median(times[20:]))
    sel = _stall_window(times, stamps, loop_stamps)
    worst = float(times[sel].max()) if sel.any() else None
    return slam, states, dict(times=times, med=med, sel=sel, worst=worst,
                              bound=max(3.0 * med, med + 0.5),
                              load=np.asarray(load))


def _mapping_load(st) -> str:
    """The mapping load of a _run_online_pillar run, over the run and in
    its stall window."""
    inserted, refused, queued = st["load"].T
    sel = st["sel"]
    return (f"keyframes inserted {int(inserted.sum())}, refused "
            f"{int(refused.sum())}, longest queue {int(queued.max())}; in "
            f"the stall window inserted {int(inserted[sel].sum())}, refused "
            f"{int(refused[sel].sum())}, longest queue "
            f"{int(queued[sel].max()) if sel.any() else 0}")


def _online_pillar(smi, orbit, orbit_twc, offline_loop):
    """a. pillar-84 online: the checks and the prints."""
    from airdos_tpu_torch.utils.gate import TRACKING_PRIORITY

    slam, states, st = _run_online_pillar(orbit)
    counts, tally = _counts(), _tally()     # counted from 0 at the phase
    lc = slam.loop_closer
    times, sel, worst, med = st["times"], st["sel"], st["worst"], st["med"]
    ms = times * 1e3
    print(f"[online] pillar-{len(orbit)}: states {collections.Counter(states)}"
          f", keyframes {len(slam.map.kfs)} inserted "
          f"({slam.map.n_keyframes()} live), loops closed "
          f"{lc.closed if lc else None}, global BA runs "
          f"{slam.global_ba.n_runs} (aborted {slam.global_ba.n_aborted}); "
          f"launches {counts}")
    if states[-1] != "OK":
        _fail(f"online: the last pillar frame is {states[-1]}")
    if lc is None or lc.n_loops_closed < 1:
        _fail("online: no loop closed")
    if slam.global_ba.n_runs < 1:
        _fail("online: the global BA never ran in its background thread")
    ate = _ate(slam.tracking, orbit_twc)
    if not ate < 0.15:
        _fail(f"online: pillar ATE {ate} m >= 0.15 m")
    warm = times[20:]
    stalled = times[sel]
    off = offline_loop
    print(f"[online] pillar ATE {ate:.6f} m; tracking-frame ms online (all "
          f"{len(ms)} frames, the tracking thread's host time): "
          f"{_ms_stats(ms)}, after frame 20 {_ms_stats(warm * 1e3)}; offline "
          f"in phase loop: tracking frames {_ms_stats(off['track_ms'])}, all "
          f"frames {_ms_stats(off['all_ms'])}, loop frames "
          f"{[round(x, 2) for x in off['loop_ms']]} ms; loop stall window "
          f"{len(stalled)} frames, worst "
          f"{'none' if worst is None else f'{worst * 1e3:.2f}'} ms against "
          f"the bound max(3 x {med * 1e3:.2f}, {med * 1e3:.2f} + 500) ms on "
          f"{smi}", flush=True)
    print(f"[online] stall window frames (ms): "
          f"{[round(float(x) * 1e3, 1) for x in stalled]}", flush=True)
    print(f"[online] mapping load online: {_mapping_load(st)}; offline in "
          f"phase loop: keyframes inserted {off['n_kfs']}", flush=True)
    if worst is not None and not worst < st["bound"]:
        _fail(f"online: a loop closure stalled tracking: {worst} s against "
              f"a median of {med} s")
    spans = slam.profiler.report()
    print("[online] worker spans (median ms): " + ", ".join(
        f"{k} {v['median_s'] * 1e3:.2f} (n {v['n']}, max "
        f"{max(slam.profiler.stages[k]) * 1e3:.2f})"
        for k, v in sorted(spans.items())
        if k.startswith(("map.", "loop.", "gba.", "ba.", "track"))),
        flush=True)
    print("[online] launches by (kernel, thread, stream priority): "
          + ", ".join(f"{k} {v}" for k, v in sorted(tally.items())),
          flush=True)
    track_prio = {p for (name, th, p) in tally if th == "MainThread"
                  and name == "hamming_matrix"}
    worker = {(name, p) for (name, th, p) in tally if th == "mapping"
              and name in ("hamming_matrix_batched", "segment_sum")}
    if not track_prio or {n for n, _ in worker} != \
            {"hamming_matrix_batched", "segment_sum"}:
        _fail(f"online: launches missing from the tally {tally}")
    if track_prio != {min(track_prio)} or min(track_prio) > \
            TRACKING_PRIORITY:
        _fail(f"online: tracking's 2-D Hamming launches on priorities "
              f"{track_prio}")
    if any(p <= max(track_prio) for _, p in worker):
        _fail(f"online: the mapping worker's launches {worker} are not on "
              f"a stream of lower priority than tracking's {track_prio}")


def _online_human(smi, crowd, crowd_twc):
    """b. crowd-27 online human (tests/test_online_human.py)."""
    from airdos_tpu_torch.slam.system import System

    cfg = _human_bench_config()
    cfg.system.is_offline = False
    slam = System(cfg, device="cuda")
    launched = []
    real_launch = slam.human_ba.launch

    def launch(kf_id):
        ok = real_launch(kf_id)
        launched.append(ok)
        return ok
    slam.human_ba.launch = launch
    for data in crowd:
        slam.track_stereo_human(data)
    slam.shutdown()          # raises what the background human BA raised
    n_opt = sum(t.optimized for t in slam.map.trajectories.values())
    ate_h = _ate(slam.tracking, crowd_twc)
    times, _, _ = _frame_events(slam)
    print(f"[online] crowd-{len(crowd)} flagship: state "
          f"{slam.tracking.state.name}, human BA launches {launched.count(True)}"
          f" (ticks skipped while one ran {launched.count(False)}), solves "
          f"{slam.human_ba.n_runs}, trajectories optimized {n_opt}, ATE "
          f"{ate_h:.6f} m; tracking-frame ms {_ms_stats(times * 1e3)} on "
          f"{smi}", flush=True)
    if slam.tracking.state.name != "OK":
        _fail("online human: the last frame is not OK")
    if slam.human_ba.n_runs < 2 or launched.count(True) < 2:
        _fail(f"online human: {slam.human_ba.n_runs} human BA solves")
    if n_opt < 1:
        _fail("online human: no trajectory optimized")
    if not ate_h < 0.03:
        _fail(f"online human: ATE {ate_h} m >= 0.03 m")


def _online_api(frames, twc):
    """c. localization-only mode, reset and prefetch on static-28."""
    import torch
    from airdos_tpu_torch.slam.frame import FrontEnd
    from airdos_tpu_torch.slam.system import System
    from airdos_tpu_torch.utils.gate import TRACKING_PRIORITY

    cfg = _bench_config()
    cfg.system.is_offline = False
    slam = System(cfg, device="cuda")
    for data in frames[:18]:
        slam.track_stereo(data)
    if not slam.drain_mapping(120.0):
        _fail("api: the mapping worker did not drain")
    slam.global_ba.join()
    n_kfs, n_pts = len(slam.map.kfs), slam.map.n_points()
    slam.activate_localization_mode()
    loc = []
    for data in frames[18:]:
        frame = slam.track_stereo(data)
        loc.append(slam.tracking.state.name)
    err = float(np.linalg.norm(frame.Ow - twc[len(frames) - 1]))
    print(f"[online] localization-only frames 18-{len(frames) - 1}: states "
          f"{collections.Counter(loc)}, keyframes {n_kfs} -> "
          f"{len(slam.map.kfs)}, points {n_pts} -> {slam.map.n_points()}, "
          f"last pose error {err:.4f} m", flush=True)
    if set(loc) != {"OK"} or len(slam.map.kfs) != n_kfs or \
            slam.map.n_points() != n_pts or not err < 0.5:
        _fail("api: localization-only mode changed the map or lost track")
    slam.deactivate_localization_mode()
    slam.shutdown()

    slam = System(cfg, device="cuda")
    for data in frames[:6]:
        slam.track_stereo(data)
    resets = []
    for start, with_gba in ((6, False), (12, True)):
        if with_gba:
            slam.global_ba.launch(slam._map_lock)
        running = slam.global_ba._thread is not None and \
            slam.global_ba._thread.is_alive()
        slam.reset()
        if slam.map.n_keyframes() != 0 or slam.tracking.records or \
                slam.tracking.state.name != "NOT_INITIALIZED":
            _fail("api: reset left a map or a state behind")
        for data in frames[start:start + 6]:
            slam.track_stereo(data)
        resets.append((start, running, slam.tracking.state.name,
                       slam.map.n_keyframes()))
        if slam.tracking.state.name != "OK" or slam.map.n_keyframes() < 1:
            _fail(f"api: no re-initialization after the reset at {start}")
    slam.shutdown()
    if not resets[1][1]:
        _fail("api: the global BA was not running at the second reset")
    print(f"[online] resets (frame, global BA running, state, keyframes "
          f"after 6 frames): {resets}; global BA aborted "
          f"{slam.global_ba.n_aborted}", flush=True)

    fe = FrontEnd(cfg, device="cuda")
    side = torch.cuda.Stream(priority=TRACKING_PRIORITY)
    with torch.cuda.stream(side):
        plain = fe.build_frame(frames[5])
        fe.prefetch(frames[5])
        pre = fe.build_frame(frames[5])
    same = all(np.array_equal(getattr(plain, k), getattr(pre, k))
               for k in ("xy", "desc32", "octave", "valid", "u_right"))
    print(f"[online] prefetched frame 5 on a second stream: keypoints, "
          f"descriptors, octaves and stereo bit-equal to the plain upload: "
          f"{same} ({int(plain.valid.sum())} features)", flush=True)
    if not same:
        _fail("api: a prefetched frame differs from the plain upload")


def _replay(snap, device, extractor):
    """compute_sim3 -> correct of the snapshot's loop on a deep copy of
    it, on `device` (the CPU gets its own vocabulary tables, fuser and
    global BA over the copied map)."""
    from airdos_tpu_torch.convert import (loop_closer_state_from,
                                          vocabulary_from)
    from airdos_tpu_torch.slam.ba_driver import Fuser, GlobalBA
    from airdos_tpu_torch.slam.keyframe_db import KeyFrameDatabase
    from airdos_tpu_torch.slam.loop_closing import LoopCloser
    src, kf_id, cand = snap
    lc = copy.deepcopy(src)
    if device == "cpu":
        m, cfg = lc.map, lc.config
        db = KeyFrameDatabase(vocabulary_from(lc.db.voc, device="cpu"), m)
        db.inverted = lc.db.inverted
        cpu = LoopCloser(cfg, m, db, extractor, "cpu",
                         fuser=Fuser(cfg, m, extractor, device="cpu"),
                         global_ba=GlobalBA(cfg, m, extractor, device="cpu"))
        loop_closer_state_from(lc, cpu)
        lc = cpu
    kf = lc.map.kfs[kf_id]
    res = lc.compute_sim3(kf, cand)
    if res is None or not lc.correct(kf, res):
        _fail(f"loop replay on {device}: the loop {kf_id} -> {cand} did not "
              f"close again")
    return lc.map


def phase_loop_replay(snap, extractor):
    """Loop determinism and agreement: compute_sim3 -> correct (essential
    graph and global BA included) of the first closed loop, replayed on
    two deep copies of the closer taken when it ran, on the card (the KF /
    MP / Match dumps byte-identical) and on the CPU (keyframes within the
    tolerance of tests/test_torch_loop_system.py: 2e-3 in R, 5e-3 m in
    t)."""
    sigma2 = extractor.sigma2
    t0 = time.perf_counter()
    a, b = (_replay(snap, "cuda", extractor) for _ in range(2))
    card_s = (time.perf_counter() - t0) / 2
    da, db_ = _dump_map(a, sigma2), _dump_map(b, sigma2)
    if da != db_:
        _fail("loop determinism: two card replays of the loop differ")
    t0 = time.perf_counter()
    c = _replay(snap, "cpu", extractor)
    cpu_s = time.perf_counter() - t0
    dR = max(float(np.abs(a.kfs[k].Rcw - c.kfs[k].Rcw).max())
             for k in a.kfs if not a.kfs[k].bad)
    dt = max(float(np.abs(a.kfs[k].tcw - c.kfs[k].tcw).max())
             for k in a.kfs if not a.kfs[k].bad)
    print(f"[loop-replay] keyframe {snap[1]} -> candidate {snap[2]}: two card "
          f"replays byte-identical ({len(da)} bytes of KF/MP/Match, "
          f"{card_s:.2f} s each); CPU vs card keyframes max |dR| {dR:.2e}, "
          f"max |dt| {dt:.2e} m (CPU replay {cpu_s:.2f} s)", flush=True)
    if dR > 2e-3 or dt > 5e-3:
        _fail(f"loop agreement: CPU vs card keyframes |dR| {dR}, |dt| {dt}")


def _corridor(rng, C: int, P: int, per_cam: int):
    """tests/test_global_ba.py's drifting corridor: C cameras along z
    (0.25 m apart), P points, up to per_cam stereo observations a camera
    (0.2 px noise), points off by 0.05 m, and the test's camera drift at
    its last (200th) keyframe reached at the C-th: (0.2, 0.1, 0.15) m and
    0.1 rad of yaw (the test's 0.0005 rad a keyframe would reach 0.5 rad
    at 1000 keyframes, beyond what 20 Gauss-Newton steps start from).
    Returns the solver's arrays (first camera fixed), the cameras' true
    centres and the drifted ones."""
    fx = fy = 300.0
    cx, cy, bf = 160.0, 120.0, 60.0
    ctr_gt = np.stack([0.01 * np.arange(C), np.zeros(C), 0.25 * np.arange(C)],
                      axis=1).astype(np.float32)
    pts_gt = np.stack([rng.uniform(-6, 6, P), rng.uniform(-4, 4, P),
                       rng.uniform(2, 0.25 * C + 10, P)],
                      axis=1).astype(np.float32)
    cams, pids, obs = [], [], []
    order = np.argsort(pts_gt[:, 2])
    zs = pts_gt[order, 2]
    for c in range(C):
        lo, hi = np.searchsorted(zs, [ctr_gt[c, 2] + 1.0,
                                      ctr_gt[c, 2] + 25.0])
        sel = order[lo:hi]
        xc = pts_gt[sel] - ctr_gt[c]
        u = fx * xc[:, 0] / xc[:, 2] + cx
        v = fy * xc[:, 1] / xc[:, 2] + cy
        ok = (u > 0) & (u < 320) & (v > 0) & (v < 240)
        sel, u, v, z = sel[ok], u[ok], v[ok], xc[ok, 2]
        keep = rng.permutation(len(sel))[:per_cam]
        n = len(keep)
        cams.append(np.full(n, c, np.int32))
        pids.append(sel[keep].astype(np.int32))
        obs.append(np.stack([u[keep], v[keep], u[keep] - bf / z[keep]], 1)
                   + rng.normal(0, 0.2, (n, 3)))
    e_cam, e_pt = np.concatenate(cams), np.concatenate(pids)
    e_obs = np.concatenate(obs).astype(np.float32)
    ctr_n = ctr_gt + np.linspace(0, 1, C)[:, None] * \
        np.array([0.2, 0.1, 0.15], np.float32)
    yaw = 0.1 * np.arange(C) / max(C, 200)
    R_n = np.zeros((C, 3, 3), np.float32)
    R_n[:, 0, 0] = R_n[:, 2, 2] = np.cos(yaw)
    R_n[:, 0, 2], R_n[:, 2, 0] = np.sin(yaw), -np.sin(yaw)
    R_n[:, 1, 1] = 1.0
    t_n = -np.einsum("cij,cj->ci", R_n, ctr_n).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[0] = True
    E = len(e_cam)
    arrays = (R_n, t_n, fixed,
              (pts_gt + rng.normal(0, 0.05, pts_gt.shape)).astype(np.float32),
              np.ones(P, bool), e_cam, e_pt, e_obs,
              np.ones(E, np.float32), np.ones(E, bool))
    return arrays, (fx, fy, cx, cy, bf), ctr_gt, ctr_n


def _chi2_sum(dev, cam, R, t, pts) -> float:
    """The reprojection chi2 of every edge of a global BA problem (device
    arrays as solve_global_ba takes them) at (R, t, pts)."""
    from airdos_tpu_torch.solvers.local_ba import _proj_residual
    e_cam, e_pt = dev[5].long(), dev[6].long()
    e, _, _, _ = _proj_residual(R[e_cam], t[e_cam], pts[e_pt], dev[7], *cam,
                                dev[7][:, 2] >= 0)
    return float(((e * e).sum(-1) * dev[8]).sum())


def _timed_device(fn, reps: int = 2):
    """Runs fn reps times, each ended by a synchronize; the host seconds
    of each run and the results."""
    out, secs = [], []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        out.append(fn())
        _sync()
        secs.append(time.perf_counter() - t0)
    return secs, out


def _busy_ms(fn):
    """Device busy time (ms) of one call of fn and its kernel count, from
    torch.profiler's CUDA trace (device activity only: a solve launches
    ~50,000 kernels, and host events would triple what the trace holds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3, len(evs)


def phase_map_scale(smi: str):
    """The loop solvers at the map scale airdos_tpu's GlobalBA is built for
    (solvers/global_ba.py: hundreds of keyframes, 10^5 points): the global
    BA in GlobalBA's schedule over tests/test_global_ba.py's corridor at
    C = 1000 keyframes, P = 100,000 points, ~300 observations a keyframe,
    and the essential graph over the same 1000 keyframes with one loop
    edge (D = 7000).  Each runs twice on the card, bit-equal."""
    import torch
    from airdos_tpu_torch.convert import to_device
    from airdos_tpu_torch.slam.ba_driver import solve_global_ba
    from airdos_tpu_torch.solvers.global_ba import launches_per_step
    from airdos_tpu_torch.solvers.pose_graph import optimize_essential_graph

    C, P = 1000, 100_000
    t0 = time.perf_counter()
    arrays, cam, ctr_gt, ctr_n = _corridor(np.random.default_rng(SEED), C, P,
                                           300)
    E = len(arrays[5])
    print(f"[map-scale] corridor C {C}, P {P}, E {E} edges made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dev = [to_device(a, "cuda") for a in arrays]
    _reset_counts()
    secs, outs = _timed_device(lambda: solve_global_ba(*dev, *cam))
    launches = _counts()
    want = 2 * 20 * launches_per_step(48)
    if launches["segment_sum"] != want:
        _fail(f"map scale: {launches['segment_sum']} segment_sum launches in "
              f"two global BAs, not {want}")
    (R1, t1, p1), (R2, t2, p2) = outs
    if not (torch.equal(R1, R2) and torch.equal(t1, t2)
            and torch.equal(p1, p2)):
        _fail("map scale: two card runs of the global BA differ")
    R, t = R1.cpu().numpy(), t1.cpu().numpy()
    moved = np.linalg.norm(t[1:] - arrays[1][1:], axis=1)
    chi0 = _chi2_sum(dev, cam, dev[0], dev[1], dev[3])
    chi1 = _chi2_sum(dev, cam, R1, t1, p1)
    ctr = -np.einsum("cij,ci->cj", R, t)
    e0 = np.linalg.norm(ctr_n - ctr_gt, axis=1)
    e1 = np.linalg.norm(ctr - ctr_gt, axis=1)
    if not ((moved > 1e-5).all() and chi1 < 1e-2 * chi0):
        _fail(f"map scale: free keyframes moved {(moved > 1e-5).mean():.3f}, "
              f"reprojection chi2 {chi0} -> {chi1}")
    busy, n_k = _busy_ms(lambda: solve_global_ba(*dev, *cam))
    print(f"[map-scale] global BA (4 calls x 5 steps, 48 CG iterations): "
          f"{[round(s, 3) for s in secs]} s per solve, two runs bit-equal, "
          f"{launches['segment_sum'] // 2} segment_sum launches each "
          f"(camera-keyed {C} x 42 | 42 | 6, point-keyed {P} x 12 | 3 over "
          f"{E} rows); device busy {busy:.2f} ms in {n_k} kernels "
          f"(torch.profiler, a third solve); every free keyframe moved; "
          f"reprojection chi2 {chi0:.6g} -> {chi1:.6g}; mean centre error to "
          f"the truth {e0.mean():.4f} -> {e1.mean():.4f} m over all "
          f"keyframes, {e0[:200].mean():.4f} -> {e1[:200].mean():.4f} m over "
          f"the first 200 on {smi}", flush=True)

    # the essential graph: the drifted chain as odometry edges, one loop
    # edge from the true relative pose of the last and first keyframes
    Rg = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    tg = -ctr_gt
    Rn, tn = arrays[0], arrays[1]
    ei = np.concatenate([np.arange(C - 1), [C - 1]]).astype(np.int32)
    ej = np.concatenate([np.arange(1, C), [0]]).astype(np.int32)
    Rs = np.concatenate([Rn[1:] @ Rn[:-1].transpose(0, 2, 1),
                         (Rg[0] @ Rg[C - 1].T)[None]])
    ts = np.concatenate([tn[1:] - np.einsum("eij,ej->ei", Rs[:-1], tn[:-1]),
                         (tg[0] - Rs[-1] @ tg[C - 1])[None]])
    fixed = np.zeros(C, bool)
    fixed[0] = True
    args = [to_device(a, "cuda", np.float32 if a.dtype.kind == "f" else None)
            for a in (Rn, tn, np.ones(C, np.float32), fixed, ei, ej, Rs, ts,
                      np.ones(C, np.float32), np.ones(C, bool))]
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    secs, outs = _timed_device(lambda: optimize_essential_graph(*args))
    eg = _counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k: launches[k] + eg[k] for k in launches}
    if eg["segment_sum"] != 40:
        _fail(f"map scale: {eg['segment_sum']} segment_sum launches in two "
              f"essential graphs, not 40")
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        _fail("map scale: two card runs of the essential graph differ")
    t_out = outs[0][1].cpu().numpy()
    moved = np.linalg.norm(t_out[1:] - tn[1:], axis=1)
    err0 = float(np.linalg.norm(tn[-1] - tg[-1]))
    err1 = float(np.linalg.norm(t_out[-1] - tg[-1]))
    if not ((moved > 1e-6).all() and err1 < 0.5 * err0):
        _fail(f"map scale: essential graph moved "
              f"{(moved > 1e-6).mean():.3f} of the free keyframes, loop end "
              f"error {err0} -> {err1} m")
    busy, n_k = _busy_ms(lambda: optimize_essential_graph(*args))
    print(f"[map-scale] essential graph K {C} (D {7 * C}), E {C} edges, 20 "
          f"LM steps: {[round(s, 3) for s in secs]} s per solve, two runs "
          f"bit-equal, 20 segment_sum launches each (one compact segment "
          f"sum of the 14x14 + 14 entries of every edge a step); peak "
          f"device memory {peak:.2f} GiB; device busy {busy:.2f} ms in "
          f"{n_k} kernels; loop end error {err0:.4f} -> {err1:.4f} m on "
          f"{smi}", flush=True)
    return launches


def phase_determinism():
    """Two card runs of the mapping System: byte-identical outputs."""
    from airdos_tpu_torch.slam.system import System
    frames = _small_frames(8)
    OUT_DIR.mkdir(exist_ok=True)
    outs = []
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        for tag in ("a", "b"):
            slam = System(_small_config(), device="cuda")
            _run(slam, frames)
            traj = Path(tmp) / f"traj_{tag}.txt"
            dump = Path(tmp) / f"dump_{tag}"
            slam.save_trajectory_tum(traj)
            slam.before_end(dump)
            outs.append([traj.read_bytes()] + [
                (dump / f).read_bytes()
                for f in ("KF.txt", "MP.txt", "Match.txt")])
            if slam.static_ba.n_solves < 1:
                _fail("determinism: the run made no BA solve")
    if outs[0] != outs[1]:
        diff = [f for f, a, b in zip(("traj", "KF", "MP", "Match"), *outs)
                if a != b]
        _fail(f"determinism: two card runs differ in {diff}")
    print(f"[determinism] small camera, 8 frames, two card runs: TUM and "
          f"KF/MP/Match byte-identical ({sum(map(len, outs[0]))} bytes)",
          flush=True)

    names = ("KF.txt", "MP.txt", "Match.txt", "HMTraj.txt", "Motion.txt")
    frames = _small_human_frames(10)
    outs = []
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        for tag in ("a", "b"):
            slam = System(_small_human_config(), device="cuda")
            _run(slam, frames)
            traj = Path(tmp) / f"traj_{tag}.txt"
            dump = Path(tmp) / f"dump_{tag}"
            slam.save_trajectory_tum(traj)
            slam.before_end(dump)
            outs.append([traj.read_bytes()] + [(dump / f).read_bytes()
                                               for f in names])
            if slam.human_ba.n_runs < 2:
                _fail(f"determinism: the human run made "
                      f"{slam.human_ba.n_runs} human BA solves, not >= 2")
    if outs[0] != outs[1]:
        diff = [f for f, a, b in zip(("traj",) + names, *outs) if a != b]
        _fail(f"determinism: two human card runs differ in {diff}")
    print(f"[determinism] human System, small camera, 10 frames, "
          f"{slam.human_ba.n_runs} human BA solves, two card runs: TUM and "
          f"KF/MP/Match/HMTraj/Motion byte-identical "
          f"({sum(map(len, outs[0]))} bytes)", flush=True)


def phase_cpu_agreement():
    """The same small-camera frames through the mapping System on the CPU
    (plain versions) and on the card: the same branches and keyframes,
    poses within 5 mm / 1e-3."""
    from airdos_tpu_torch.slam.system import System
    frames = _small_frames(6)
    cpu = System(_small_config(), device="cpu")
    gpu = System(_small_config(), device="cuda")
    per_cpu = _run(cpu, frames)
    per_gpu = _run(gpu, frames)
    if [p[:2] for p in per_cpu] != [p[:2] for p in per_gpu]:
        _fail(f"CPU and GPU branches differ: {per_cpu} vs {per_gpu}")
    _, R_c, t_c = cpu.tracking.trajectory_tum()
    _, R_g, t_g = gpu.tracking.trajectory_tum()
    dt = float(np.abs(t_c - t_g).max())
    dR = float(np.abs(R_c - R_g).max())
    if cpu.map.n_keyframes() != gpu.map.n_keyframes() or dt > 5e-3 \
            or dR > 1e-3:
        _fail(f"CPU vs GPU: keyframes {cpu.map.n_keyframes()} vs "
              f"{gpu.map.n_keyframes()}, max |dt| {dt}, max |dR| {dR}")
    print(f"[agree] mapping System, small camera, 6 frames: CPU and GPU "
          f"branches equal, keyframes {gpu.map.n_keyframes()}, BA solves "
          f"{gpu.static_ba.n_solves}, max |dt| {dt:.2e} m, max |dR| "
          f"{dR:.2e}", flush=True)

    frames = _small_human_frames(10)
    runs = []
    for device in ("cpu", "cuda"):
        slam = System(_small_human_config(), device=device)
        first = {}
        write_back = slam.human_ba._write_back

        def snapshot(problem, res, write_back=write_back, first=first):
            write_back(problem, res)
            if not first:        # the joints after the first solve
                first.update({t.track_id: np.stack(
                    [hp.joints_w[:14] for hp in t.poses])
                    for t in problem["trajs"]})
                first["observed"] = {t.track_id: np.stack(
                    [hp.in_keyframe & ~hp.bad[:14] for hp in t.poses])
                    for t in problem["trajs"]}
        slam.human_ba._write_back = snapshot
        runs.append((slam, _run(slam, frames), first))
    (cpu, per_cpu, f_cpu), (gpu, per_gpu, f_gpu) = runs
    if [p[:2] for p in per_cpu] != [p[:2] for p in per_gpu]:
        _fail(f"human: CPU and GPU branches differ: {per_cpu} vs {per_gpu}")
    shape = {k: len(t) for k, t in cpu.map.trajectories.items()}
    if shape != {k: len(t) for k, t in gpu.map.trajectories.items()}:
        _fail("human: CPU and GPU trajectories differ")
    _, _, t_c = cpu.tracking.trajectory_tum()
    _, _, t_g = gpu.tracking.trajectory_tum()
    dt = float(np.abs(t_c - t_g).max())
    obs_gap, other_gap = [0.0], [0.0]
    for tid, observed in f_cpu.pop("observed").items():
        g = np.linalg.norm(f_cpu[tid] - f_gpu[tid], axis=-1)
        obs_gap.append(float(g[observed].max(initial=0.0)))
        other_gap.append(float(g[~observed].max(initial=0.0)))
    end = np.concatenate([np.linalg.norm(
        a.joints_w[:14] - b.joints_w[:14], axis=-1).ravel()
        for tid in cpu.map.trajectories for a, b in zip(
            cpu.map.trajectories[tid].poses, gpu.map.trajectories[tid].poses)])
    print(f"[agree] human System, small camera, 10 frames, "
          f"{gpu.human_ba.n_runs} human BA solves: CPU and GPU branches and "
          f"trajectories equal, cameras max |dt| {dt:.2e} m; after the "
          f"first solve joints with an inlier projection edge max gap "
          f"{max(obs_gap):.2e} m, other joints {max(other_gap):.2e} m; end "
          f"of run joint gap median {np.median(end):.2e} m, max "
          f"{end.max():.2e} m", flush=True)
    if dt > 1e-4 or max(obs_gap) > 5e-3:
        _fail(f"human: CPU vs GPU cameras {dt} m or observed joints "
              f"{max(obs_gap)} m beyond 1e-4 / 5e-3 m")


def phase_profile(smi: str):
    """Where the time goes at the bench size, mapping System over the 28
    bench frames: stage timers with a synchronize on both sides (tracking
    stages per fused frame from frame 6 on; triangulation, fusion and the
    BA solve per keyframe), then torch.profiler over the last two frames
    (device kernels per frame, device busy time and share).  The
    profiler's tables go to chiprun_out/profile_slice.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import airdos_tpu_torch.slam.ba_driver as ba_driver
    import airdos_tpu_torch.slam.frame as frame_mod
    import airdos_tpu_torch.slam.fused as fused
    from airdos_tpu_torch.slam.system import System

    frames, _ = _bench_frames(N_FRAMES)
    slam = System(_bench_config(), device="cuda")
    acc = collections.defaultdict(float)

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            acc[name] += time.perf_counter() - t0
            return out
        return wrapped

    track_stages = [
        (slam.frontend, "_build_impl", "front end (both images, stereo)"),
        (frame_mod, "stereo_match", "  of which stereo match"),
        (fused, "match_last_frame", "motion-model match"),
        (fused, "match_local_points", "local-map match"),
        (fused, "pose_optimize", "pose LM")]
    lm = slam.local_mapper
    map_stages = [(lm, "triangulator", "triangulation"),
                  (lm, "fuser", "fusion"),
                  (ba_driver, "local_bundle_adjust", "BA solve")]
    for obj, attr, name in track_stages + map_stages:
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    fast_rows, kf_rows = [], []
    for i, d in enumerate(frames[:-2]):
        before = dict(acc)
        t0 = time.perf_counter()
        slam.track_stereo(d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = {k: acc[k] - before.get(k, 0.0) for k in acc}
        row["frame total"] = wall
        kf = slam.map.kfs.get(slam.tracking.last_kf_id)
        if kf is not None and kf.frame_id == d.index and i > 0:
            kf_rows.append(row)
        elif i >= 6 and slam.tracking.last_branch == "fast":
            fast_rows.append(row)
    for rows, label, names in (
            (fast_rows, "fused frames without a keyframe, from frame 6",
             [n for _, _, n in track_stages]),
            (kf_rows, "keyframe frames after the first",
             [n for _, _, n in map_stages])):
        print(f"[profile] {label}: {len(rows)}; synchronized stage timers, "
              f"median ms per frame on {smi}:")
        for name in names + ["frame total"]:
            v = [r.get(name, 0.0) * 1e3 for r in rows]
            print(f"[profile]   {name:32s} ms "
                  f"{np.median(v) if v else float('nan'):9.2f}")
    stages = slam.profiler.report()
    print("[profile] spans (median ms): " + ", ".join(
        f"{k} {v['median_s'] * 1e3:.2f} (n {v['n']})"
        for k, v in sorted(stages.items())))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for d in frames[-2:]:
            slam.track_stereo(d)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 2 * 1e3
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in evs) / 2 / 1e3

    def kernel_ms(tag):
        t = [e.time_range.elapsed_us() for e in evs if tag in e.name]
        return len(t), (f"{sum(t) / len(t) / 1e3:.4f} ms" if t
                        else "not measured")

    n_ham, ham_ms = kernel_ms("hamming_kernel")
    n_seg, seg_ms = kernel_ms("segment_sum_")
    print(f"[profile] frames {N_FRAMES - 2}-{N_FRAMES - 1} under "
          f"torch.profiler: {len(evs) / 2:.0f} device kernels per frame, "
          f"device busy {busy_ms:.2f} ms per frame, wall {wall_ms:.2f} ms "
          f"per frame (the profiler slows the host), busy share "
          f"{busy_ms / wall_ms:.4f}; hamming_kernel {n_ham} launches, mean "
          f"device time {ham_ms}; segment_sum {n_seg} launches, mean "
          f"device time {seg_ms}; on {smi}")
    OUT_DIR.mkdir(exist_ok=True)
    out = OUT_DIR / "profile_slice.txt"
    ka = prof.key_averages()
    out.write_text(ka.table(sort_by="self_cuda_time_total", row_limit=40)
                   + "\n" + ka.table(sort_by="count", row_limit=25))
    print(f"[profile] tables in {out}", flush=True)

    # the flagship's human BA stages: assembly and write-back on the host,
    # the solve ending in its one copy back (a device sync)
    crowd, _ = _crowd_frames(N_CROWD)
    slam = System(_human_bench_config(), device="cuda")
    _run(slam, crowd)
    stages = slam.profiler.report()
    print(f"[profile] crowd-{N_CROWD} flagship, {slam.human_ba.n_runs} human "
          f"BA solves; spans (median / max ms): " + ", ".join(
              f"{k} {v['median_s'] * 1e3:.2f} / "
              f"{max(slam.profiler.stages[k]) * 1e3:.2f}"
              for k, v in sorted(stages.items())
              if k.startswith(("human_ba", "hba."))) + f" on {smi}",
          flush=True)

    # one more solve of the last window under torch.profiler: the solve's
    # device busy time against its wall time, and the kernels that hold it
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        slam.human_ba(slam.map, slam.tracking.last_kf_id)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    per_kernel = collections.defaultdict(float)
    for e in evs:
        per_kernel[e.name] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    print(f"[profile] one human BA solve under torch.profiler: wall "
          f"{wall_ms:.2f} ms (the profiler slows the host), {len(evs)} "
          f"device kernels, device busy {busy_ms:.2f} ms (share "
          f"{busy_ms / wall_ms:.4f}); most device time: " + "; ".join(
              f"{name[:60]} {ms:.2f} ms" for name, ms in top) +
          f" on {smi}", flush=True)


def _settings_yaml(cfg) -> str:
    """A reference-format settings YAML (the keys of the reference's
    Examples/Stereo/config/*.yaml and the port's Device.* budgets, as
    tests/test_examples_cli.py writes them) whose SlamConfig.from_yaml is
    cfg, field for field; fails if it is not."""
    from airdos_tpu_torch.config import SlamConfig
    c, o, h, p, s = cfg.camera, cfg.orb, cfg.human, cfg.optimizer, cfg.system
    d = cfg.device
    keys = {
        "Camera.fx": c.fx, "Camera.fy": c.fy, "Camera.cx": c.cx,
        "Camera.cy": c.cy, "Camera.k1": c.k1, "Camera.k2": c.k2,
        "Camera.p1": c.p1, "Camera.p2": c.p2, "Camera.k3": c.k3,
        "Camera.width": c.width, "Camera.height": c.height,
        "Camera.fps": c.fps, "Camera.bf": c.bf, "Camera.RGB": c.rgb,
        "ThDepth": cfg.th_depth,
        "ORBextractor.nFeatures": o.n_features,
        "ORBextractor.scaleFactor": o.scale_factor,
        "ORBextractor.nLevels": o.n_levels,
        "ORBextractor.iniThFAST": o.ini_th_fast,
        "ORBextractor.minThFAST": o.min_th_fast,
        "Human.OK": h.ok, "Human.isSeg": h.is_seg,
        "Human.UseTrackedId": h.use_tracked_id, "Human.RejectTh": h.reject_th,
        "Optimizer.SigmaStatic": p.sigma_static,
        "Optimizer.SigmaHuman": p.sigma_human,
        "Optimizer.SigmaMotion": p.sigma_motion,
        "Optimizer.SigmaRigidity": p.sigma_rigidity,
        "Optimizer.ThHuberMotion": p.th_huber_motion,
        "Optimizer.ThRanSacMotion": p.th_ransac_motion,
        "Optimizer.ThRanSacRigidity": p.th_ransac_rigidity,
        "Optimizer.IsHuber": p.is_huber,
        "Optimizer.IsKeyFrameOnly": p.is_keyframe_only,
        "Optimizer.IsAllKF": p.is_all_kf,
        "Optimizer.IsStaticOnly": p.is_static_only,
        "System.IsOffline": s.is_offline, "System.IsMask": s.is_mask,
        "System.IsGroundTruthDepth": s.is_ground_truth_depth,
        "Schedular.nStartImage": cfg.scheduler.n_start_image,
        "Schedular.nEndImage": cfg.scheduler.n_end_image,
        "Device.MaxKeypoints": d.max_keypoints,
        "Device.MaxLocalKFs": d.max_local_kfs,
        "Device.MaxFixedKFs": d.max_fixed_kfs,
        "Device.MaxLocalPoints": d.max_local_points,
        "Device.MaxBAEdges": d.max_ba_edges,
        "Device.MaxTrajectories": d.max_trajectories,
        "Device.MaxTrajectoryLen": d.max_trajectory_len,
        "Device.NChips": d.n_chips}
    text = "%YAML:1.0\n" + "".join(
        f"{k}: {repr(float(v)) if isinstance(v, float) else int(v)}\n"
        for k, v in keys.items())
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "settings.yaml"
        path.write_text(text)
        back = SlamConfig.from_yaml(path)
    if dataclasses.asdict(back) != dataclasses.asdict(cfg):
        diff = {k: (v, dataclasses.asdict(cfg)[k])
                for k, v in dataclasses.asdict(back).items()
                if v != dataclasses.asdict(cfg)[k]}
        _fail(f"drivers: the settings YAML reads back otherwise: {diff}")
    return text


def _q8(img) -> np.ndarray:
    """A rendered float image as the uint8 a dataset's PNG holds."""
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _twin(d, timestamp=None):
    """What a sequence reader gives back for frame d written to disk: the
    images quantized to uint8 as float32, the detections as float64, the
    track ids as int64 (a frame without them: none)."""
    humans = {k: None if getattr(d, k) is None else
              np.asarray(getattr(d, k), np.float64).reshape(-1, 18, 3)
              for k in ("humans_left", "humans_right")}
    return dataclasses.replace(
        d, timestamp=d.timestamp if timestamp is None else timestamp,
        image_left=_q8(d.image_left).astype(np.float32),
        image_right=_q8(d.image_right).astype(np.float32),
        track_ids=None if d.track_ids is None
        else np.asarray(d.track_ids).astype(np.int64).reshape(-1),
        **humans)


def _write_rows(path: Path, rows) -> None:
    """A whitespace text matrix whose values read back bit-equal."""
    path.write_text("".join(" ".join(repr(v) for v in row) + "\n"
                            for row in np.asarray(rows).tolist()))


def _write_tartanair(root: Path, frames) -> None:
    """frames in the TartanAir-Shibuya layout (io/datasets.py): images,
    segmentation, AlphaPose detections, track ids, times.txt."""
    from airdos_tpu_torch.io.png import imwrite
    for sub in ("image_0", "image_1", "rcnnseg_image_0", "rcnnseg_image_1",
                "alphapose_0", "alphapose_1", "track_id_alpha"):
        (root / sub).mkdir(parents=True)
    for i, d in enumerate(frames):
        name = f"{i:06d}"
        imwrite(root / "image_0" / f"{name}.png", _q8(d.image_left))
        imwrite(root / "image_1" / f"{name}.png", _q8(d.image_right))
        if d.seg_left is not None:
            imwrite(root / "rcnnseg_image_0" / f"{name}.png", d.seg_left)
            imwrite(root / "rcnnseg_image_1" / f"{name}.png", d.seg_right)
        if d.humans_left is not None:
            _write_rows(root / "alphapose_0" / f"{name}.txt",
                        np.asarray(d.humans_left).reshape(-1, 54))
            _write_rows(root / "alphapose_1" / f"{name}.txt",
                        np.asarray(d.humans_right).reshape(-1, 54))
            _write_rows(root / "track_id_alpha" / f"{name}.txt",
                        np.asarray(d.track_ids).reshape(-1, 1))
    (root / "times.txt").write_text("".join(f"{float(d.timestamp)!r}\n"
                                            for d in frames))


def _same_frame(got, want) -> bool:
    """Every FrameData field equal, arrays with their dtypes."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            if not (isinstance(a, np.ndarray) and a.dtype == b.dtype
                    and a.shape == b.shape and np.array_equal(a, b)):
                return False
        elif a != b:
            return False
    return True


@contextlib.contextmanager
def _systems_made():
    """The System objects constructed inside the context (the drivers make
    theirs inside main), so their per-frame times can be read."""
    import airdos_tpu_torch.slam.system as system_mod
    made, cls = [], system_mod.System

    class Recorded(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
    system_mod.System = Recorded
    try:
        yield made
    finally:
        system_mod.System = cls


def _drive(main, args):
    """A driver's main(args) in this process, on the card (failing unless
    it returns 0): its standard output and the System it made."""
    out = io.StringIO()
    with _systems_made() as made, contextlib.redirect_stdout(out):
        rc = main(args)
    if rc != 0:
        _fail(f"drivers: {main.__module__} {args} exited {rc}: "
              f"{out.getvalue()}")
    if len(made) != 1:
        _fail(f"drivers: {main.__module__} made {len(made)} Systems")
    return out.getvalue(), made[0]


def _paeth_png(img: np.ndarray) -> bytes:
    """PNG bytes of a uint8 gray image with every row Paeth-filtered: the
    decoder's slowest rows, which libpng's writers choose for most rows of
    a natural image."""
    import struct
    import zlib
    x = img.astype(np.int64)
    a = np.pad(x, ((0, 0), (1, 0)))[:, :-1]
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]
    c = np.pad(x, ((1, 0), (1, 0)))[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = np.concatenate([np.full((x.shape[0], 1), 4),
                           (x - pred) % 256], axis=1).astype(np.uint8)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    ihdr = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], 8, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


@contextlib.contextmanager
def _kitti_cli(frames):
    """Phase 14a's subprocess, started as soon as static-28 has rendered
    so that it overlaps the other scenes' rendering: the frames written in
    the KITTI layout (uint8 PNGs, times.txt) with a settings YAML that
    reads back as _bench_config(), and python -m
    airdos_tpu_torch.examples.stereo_kitti run on them.  Yields the paths
    and the process; on leaving, the process is stopped if it still runs
    and the files are removed."""
    from airdos_tpu_torch.io.png import imwrite
    OUT_DIR.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(dir=OUT_DIR))
    proc = None
    try:
        yaml, kitti = root / "static.yaml", root / "kitti"
        yaml.write_text(_settings_yaml(_bench_config()))
        (kitti / "image_0").mkdir(parents=True)
        (kitti / "image_1").mkdir()
        for i, d in enumerate(frames):
            imwrite(kitti / "image_0" / f"{i:06d}.png", _q8(d.image_left))
            imwrite(kitti / "image_1" / f"{i:06d}.png", _q8(d.image_right))
        (kitti / "times.txt").write_text("".join(
            f"{float(d.timestamp)!r}\n" for d in frames))
        traj = root / "kitti_cli.txt"
        with open(root / "cli.log", "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m",
                 "airdos_tpu_torch.examples.stereo_kitti", str(yaml),
                 str(kitti), str(traj)],
                cwd=Path(__file__).resolve().parent, stdout=log,
                stderr=subprocess.STDOUT)
        yield dict(root=root, yaml=yaml, kitti=kitti, traj=traj, proc=proc)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(root, ignore_errors=True)


def phase_drivers(smi: str, frames, twc, crowd, crowd_twc, memory, cli):
    """The dataset drivers on the card (python -m
    airdos_tpu_torch.examples.*), each byte-identical to the in-memory
    System on the same uint8 inputs (memory: phases mapping's and
    human's trajectories; cli: _kitti_cli's); the evaluator and the
    viewer.  Returns the launch counts of the phase."""
    from airdos_tpu_torch.examples import (stereo_euroc, stereo_human,
                                           stereo_kitti)
    from airdos_tpu_torch.io.datasets import (KittiStereoSequence,
                                              TartanAirStereoSequence)
    from airdos_tpu_torch.io.png import imread_grayscale, imwrite
    from airdos_tpu_torch.io.rectify import (init_undistort_rectify_map,
                                             remap_linear)
    from airdos_tpu_torch.io.tum import ate_rmse, read_trajectory_tum
    from airdos_tpu_torch.slam.system import System
    from airdos_tpu_torch.tools import evaluate
    from airdos_tpu_torch.viz.frame_drawer import save_frame_overlay

    OUT_DIR.mkdir(exist_ok=True)
    _reset_counts()
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp_name:
        tmp = Path(tmp_name)
        # a. KITTI layout: the CLI started before the other scenes
        # rendered (_kitti_cli), then main() in this process, against
        # phase mapping's System on the same uint8 frames
        yaml, kitti = cli["yaml"], cli["kitti"]
        twins = [_twin(d) for d in frames]
        t0 = time.perf_counter()
        read = list(KittiStereoSequence(kitti))
        read_ms = (time.perf_counter() - t0) * 1e3 / (2 * len(frames))
        bad = [i for i, (g, w) in enumerate(zip(read, twins))
               if not _same_frame(g, dataclasses.replace(
                   w, humans_left=None, humans_right=None, track_ids=None,
                   seg_left=None, seg_right=None))]
        if bad:
            _fail(f"drivers: KITTI frames {bad} read back otherwise")
        try:
            rc = cli["proc"].wait(timeout=900)
        except subprocess.TimeoutExpired:
            _fail("drivers: the stereo_kitti CLI ran past 900 s")
        if rc != 0:
            _fail(f"drivers: the stereo_kitti CLI exited {rc}: "
                  f"{(cli['root'] / 'cli.log').read_text()[-4000:]}")
        cli_lines = cli["traj"].read_text().splitlines()
        if len(cli_lines) != len(frames) or \
                any(len(r.split()) != 12 for r in cli_lines):
            _fail(f"drivers: the CLI wrote {len(cli_lines)} KITTI lines")
        c0 = _counts()
        out_a, drv_a = _drive(stereo_kitti.main, [
            str(yaml), str(kitti), str(tmp / "kitti_main.txt")])
        c1 = _counts()
        launches_a = {k: c1[k] - c0[k] for k in c1}
        for tag, path in (("main", tmp / "kitti_main.txt"),
                          ("cli", cli["traj"])):
            if path.read_bytes() != memory["kitti"]:
                _fail(f"drivers: the KITTI driver's trajectory ({tag}) "
                      f"differs from the in-memory System's")
        ms_a = [t * 1e3 for t in drv_a.track_times]
        print(f"[drivers] a. KITTI layout, static-{len(frames)}: the "
              f"stereo_kitti CLI exited 0 with {len(cli_lines)} KITTI lines; "
              f"main() and the CLI byte-identical to phase mapping's "
              f"in-memory System ({len(memory['kitti'])} bytes); driver "
              f"tracking ms {_ms_stats(ms_a)}; reader {read_ms:.2f} ms per "
              f"image; launches {launches_a}; {out_a.strip()} on {smi}",
              flush=True)

        # b. TartanAir layout, the flagship on crowd-27
        human_yaml = tmp / "human.yaml"
        human_yaml.write_text(_settings_yaml(_human_bench_config()))
        tartan = tmp / "tartanair"
        _write_tartanair(tartan, crowd)
        twins = [_twin(d) for d in crowd]
        bad = [i for i, (g, w) in enumerate(zip(
            TartanAirStereoSequence(tartan), twins)) if not _same_frame(g, w)]
        if bad:
            _fail(f"drivers: TartanAir frames {bad} read back otherwise")
        c0 = _counts()
        dump = tmp / "dump"
        out_b, drv_b = _drive(stereo_human.main, [
            str(human_yaml), str(tartan), str(tmp / "human_main.txt"),
            str(dump)])
        c1 = _counts()
        launches_b = {k: c1[k] - c0[k] for k in c1}
        if (tmp / "human_main.txt").read_bytes() != memory["tartanair"]:
            _fail("drivers: the stereo_human driver's TUM differs from phase "
                  "human's in-memory flagship")
        missing = [f for f in ("KF.txt", "MP.txt", "Match.txt", "HMTraj.txt",
                               "Motion.txt") if not (dump / f).is_file()]
        if missing:
            _fail(f"drivers: SaveMap files not written: {missing}")
        ts_b, _, t_b = read_trajectory_tum(tmp / "human_main.txt")
        ate_b = float(ate_rmse(t_b, crowd_twc[:len(t_b)]))
        if not ate_b < 0.03:
            _fail(f"drivers: stereo_human ATE {ate_b} m >= 0.03 m")
        ms_b = [t * 1e3 for t in drv_b.track_times]
        print(f"[drivers] b. TartanAir layout, crowd-{len(crowd)} flagship: the "
              f"stereo_human driver's TUM byte-identical to phase human's "
              f"in-memory flagship; SaveMap files written; ATE {ate_b:.6f} m; "
              f"{drv_b.human_ba.n_runs} human BA solves; driver tracking ms "
              f"{_ms_stats(ms_b)}; launches {launches_b} on {smi}",
              flush=True)

        # c. EuRoC layout, identity rectification, static-28 frames 0-13;
        # then one frame rectified with a plumb-bob distortion
        cam = _bench_config().camera
        K = [cam.fx, 0.0, cam.cx, 0.0, cam.fy, cam.cy, 0.0, 0.0, 1.0]
        blocks = {"K": (3, 3, K), "D": (1, 5, [0.0] * 5),
                  "R": (3, 3, [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0]),
                  "P": (3, 4, K[:3] + [0.0] + K[3:6] + [0.0] + K[6:] + [0.0])}
        euroc_yaml = tmp / "euroc.yaml"
        euroc_yaml.write_text(
            _settings_yaml(_bench_config())
            + f"LEFT.width: {cam.width}\nLEFT.height: {cam.height}\n"
            + "".join(f"{side}.{key}: !!opencv-matrix\n   rows: {r}\n"
                      f"   cols: {c}\n   dt: d\n   data: ["
                      + ", ".join(repr(float(v)) for v in data) + "]\n"
                      for side in ("LEFT", "RIGHT")
                      for key, (r, c, data) in blocks.items()))
        n_euroc = min(14, len(frames))
        names = [1_403_636_579_000_000_000 + int(round(d.timestamp * 1e9))
                 for d in frames[:n_euroc]]
        for cam_dir, key in (("cam0", "image_left"), ("cam1", "image_right")):
            data_dir = tmp / "euroc" / "mav0" / cam_dir / "data"
            data_dir.mkdir(parents=True)
            for ns, d in zip(names, frames):
                imwrite(data_dir / f"{ns}.png", _q8(getattr(d, key)))
        (tmp / "euroc_ts.txt").write_text("".join(f"{ns}\n" for ns in names))
        c0 = _counts()
        _, drv_c = _drive(stereo_euroc.main, [
            str(euroc_yaml), str(tmp / "euroc"), str(tmp / "euroc_ts.txt"),
            str(tmp / "euroc_main.txt")])
        c1 = _counts()
        launches_c = {k: c1[k] - c0[k] for k in c1}
        mem = System(_bench_config(), device="cuda")
        _run(mem, [_twin(d, ns / 1e9) for ns, d in zip(names, frames)])
        mem.save_trajectory_tum(tmp / "euroc_memory.txt")
        if (tmp / "euroc_main.txt").read_bytes() != \
                (tmp / "euroc_memory.txt").read_bytes():
            _fail("drivers: the stereo_euroc driver's TUM (identity "
                  "rectification) differs from the in-memory System's")
        # the reference EuRoC.yaml's cam0 distortion and rectifying
        # rotation on this camera
        raw = _q8(frames[0].image_left)
        Kc = np.asarray(K).reshape(3, 3)
        D = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
        R = [[0.999966347530033, -0.001422739138722922, 0.008079580483432283],
             [0.001365741834644127, 0.9999741760894847, 0.007055629199258132],
             [-0.008089410156878961, -0.007044357138835809,
              0.9999424675829176]]
        t0 = time.perf_counter()
        mx, my = init_undistort_rectify_map(Kc, D, R, Kc,
                                            (cam.width, cam.height))
        maps_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rect = remap_linear(raw, mx, my)
        remap_ms = (time.perf_counter() - t0) * 1e3
        if rect.shape != raw.shape or rect.dtype != np.uint8 \
                or np.array_equal(rect, raw) or not rect.any():
            _fail("drivers: the plumb-bob rectification gave no image")
        # decode time per 640x360 image: this writer's Sub rows and an
        # all-Paeth file (libpng's writers filter most rows of a natural
        # image with Paeth or Average)
        paeth = tmp / "paeth.png"
        paeth.write_bytes(_paeth_png(raw))
        dec = {}
        for tag, path in (("sub", kitti / "image_0" / "000000.png"),
                          ("paeth", paeth)):
            t0 = time.perf_counter()
            for _ in range(3):
                img = imread_grayscale(path)
            dec[tag] = (time.perf_counter() - t0) * 1e3 / 3
            if not np.array_equal(img, raw):
                _fail(f"drivers: the {tag}-filtered PNG reads back otherwise")
        print(f"[drivers] c. EuRoC layout, static-{len(frames)} frames 0-{n_euroc - 1}, "
              f"identity rectification: the stereo_euroc driver's TUM "
              f"byte-identical to the in-memory System's; driver tracking "
              f"ms {_ms_stats([t * 1e3 for t in drv_c.track_times])}; "
              f"launches {launches_c}; plumb-bob rectification of one "
              f"{cam.width}x{cam.height} frame: maps {maps_ms:.2f} ms, remap "
              f"{remap_ms:.2f} ms; PNG decode per {cam.width}x{cam.height} "
              f"image (host): Sub rows {dec['sub']:.2f} ms, Paeth rows "
              f"{dec['paeth']:.2f} ms on {smi}", flush=True)

        # d. the evaluator on b's TUM against the ground truth as TUM
        gt = tmp / "gt.txt"
        gt.write_text("".join(
            " ".join(repr(float(v)) for v in (t, *p)) + " 0 0 0 1\n"
            for t, p in zip(ts_b, np.asarray(crowd_twc))))
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            evaluate.main(["--estimate", str(tmp / "human_main.txt"),
                           "--gt", str(gt)])
        lines = dict(line.split(":", 1) for line in
                     text.getvalue().splitlines() if ":" in line)
        ate_eval = float(lines["ATE RMSE [m]"])
        ate_sys = _ate(drv_b.tracking, crowd_twc)
        if not abs(ate_eval - ate_sys) <= 1e-6:
            _fail(f"drivers: evaluate's ATE {ate_eval} vs {ate_sys}")
        print(f"[drivers] d. evaluate on b's TUM: "
              + "; ".join(l.strip() for l in text.getvalue().splitlines())
              + f"; chip_smoke's ATE {ate_sys:.7f} m", flush=True)

    # e. the viewer on the card
    slam = System(_bench_config(), device="cuda", use_viewer=True)
    slam.viewer.keep_overlays = True
    last = None
    for d in frames[:6]:
        last = slam.track_stereo(d)
    slam.shutdown()
    v = slam.viewer
    overlay = OUT_DIR / "drivers_overlay.ppm"
    img = save_frame_overlay(str(overlay), last, slam.tracking.state.name,
                             slam.map.n_keyframes(), slam.map.n_points(),
                             image=frames[5].image_left)
    if len(v.poses) != 6 or len(v.frame_overlays) != 6 \
            or overlay.stat().st_size != 15 + img.size:
        _fail(f"drivers: the viewer recorded {len(v.poses)} poses, "
              f"{len(v.frame_overlays)} overlays")
    print(f"[drivers] e. viewer: System(use_viewer=True) recorded "
          f"{len(v.poses)} poses and overlays; overlay written to {overlay} "
          f"({overlay.stat().st_size} bytes)", flush=True)
    return _counts()


def _long_horizon_config(mask: bool, human_ba: bool):
    """tests/test_long_horizon_dynamic.py's _cfg: the small camera, the
    human BA every 5 frames over 8 x 8 poses."""
    cfg = _small_config()
    cfg.camera.fps = 5.0
    cfg.human.ok = human_ba or mask
    cfg.human.is_seg = mask
    cfg.system.is_mask = mask
    cfg.optimizer.is_static_only = not human_ba
    cfg.device.max_trajectories = 8
    cfg.device.max_trajectory_len = 8
    return cfg


def _long_horizon_frames():
    """tests/test_long_horizon_dynamic.py's 110-frame crowd: the camera
    drives through 10 drifting humans; the world (its humans are the
    ground truth), the frames and the camera centres."""
    from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
    t0 = time.perf_counter()
    world = SyntheticStereoWorld(seed=2, n_points=500, n_humans=10,
                                 cam=_small_config().camera, crowd=True)
    Rwc, twc = world.trajectory(N_LONG, 0.1, speed=0.35, yaw_rate=0.003)
    frames = _render(world, Rwc, twc, 0.1, True)
    print(f"[frames] rendered {N_LONG} long-horizon crowd frames 320x240 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return world, frames, twc


def long_horizon_metrics(world, frames, twc, device):
    """The flagship and the naive static run over the long-horizon crowd
    on `device`, and tests/test_long_horizon_dynamic.py's numbers: both
    ATEs and states, the trajectories' first and last stamps, and the
    medians of joint, velocity and limb-length errors of the optimized
    long trajectories."""
    from airdos_tpu_torch.io.synthetic import BODY1, BODY2, _SKELETON_REST
    from airdos_tpu_torch.io.tum import ate_rmse
    from airdos_tpu_torch.slam.map import TH_LONG_TRAJECTORY
    from airdos_tpu_torch.slam.system import System

    runs = {}
    for tag, mask in (("flagship", True), ("naive", False)):
        slam = System(_long_horizon_config(mask, mask), device=device)
        per = _run(slam, frames)
        _, _, t_est = slam.tracking.trajectory_tum()
        runs[tag] = (slam, float(ate_rmse(t_est, twc[:len(t_est)])),
                     slam.tracking.state.name, per)
    slam = runs["flagship"][0]
    trajs = slam.map.trajectories
    first = np.asarray([t.poses[0].timestamp for t in trajs.values()])
    last = np.asarray([t.poses[-1].timestamp for t in trajs.values()])
    seg_gt = np.linalg.norm(_SKELETON_REST[BODY1] - _SKELETON_REST[BODY2],
                            axis=1)
    joint, vel, seg = [], [], []
    for tr in trajs.values():
        if not (tr.optimized and len(tr) > TH_LONG_TRAJECTORY):
            continue
        hu = world.humans[tr.track_id]
        for hp in tr.poses:
            ok = hp.optimized[:14] & ~hp.bad[:14]
            if ok.any():
                gt = hu.joints_at(hp.timestamp)
                joint.extend(np.linalg.norm(hp.joints_w[:14][ok]
                                            - gt[:14][ok], axis=1).tolist())
        vel.append(float(np.linalg.norm(tr.motion_t - hu.velocity)))
        opt = tr.segment_optimized & ~tr.segment_bad
        if opt.any():
            seg.extend(np.abs(tr.segment_len[opt]
                              - hu.scale * seg_gt[opt]).tolist())
    return dict(runs=runs, n_trajs=len(trajs), first=first, last=last,
                joint=float(np.median(joint)) if joint else float("inf"),
                vel=float(np.median(vel)) if vel else float("inf"),
                seg=float(np.median(seg)) if seg else 0.0)


def phase_long_horizon(smi: str, world, frames, twc):
    """tests/test_long_horizon_dynamic.py on the card, its bounds held."""
    _reset_counts()
    m = long_horizon_metrics(world, frames, twc, "cuda")
    counts = _counts()
    (_, ate_h, state_h, per_h), (_, ate_n, state_n, per_n) = \
        m["runs"]["flagship"], m["runs"]["naive"]
    t_end = (len(frames) - 1) * 0.1
    ended = int((m["last"] < t_end - 1.0).sum())
    started = int((m["first"] > 1.0).sum())
    slam = m["runs"]["flagship"][0]
    print(f"[long] {len(frames)}-frame crowd, small camera: flagship ATE "
          f"{ate_h:.6f} m ({state_h}), naive {ate_n:.6f} m ({state_n}), "
          f"ratio {ate_h / ate_n:.3f}; trajectories {m['n_trajs']} ({ended} "
          f"ended early, {started} started late); medians of the optimized "
          f"long trajectories: joint error {m['joint']:.4f} m, velocity "
          f"error {m['vel']:.4f}, limb-length error {m['seg']:.4f} m; human "
          f"BA solves {slam.human_ba.n_runs}; per-frame ms flagship "
          f"{_ms_stats([p[2] * 1e3 for p in per_h])}, naive "
          f"{_ms_stats([p[2] * 1e3 for p in per_n])}; launches {counts} on "
          f"{smi}", flush=True)
    misses = []
    if state_h != "OK":
        misses.append(f"flagship state {state_h}")
    if not (ate_h < 0.8 * ate_n and ate_h < 0.05):
        misses.append(f"ATE {ate_h} vs naive {ate_n} (< 0.8x and < 0.05 m)")
    if m["n_trajs"] < 4 or ended < 1 or started < 1:
        misses.append(f"{m['n_trajs']} trajectories, {ended} ended early, "
                      f"{started} started late")
    if not (m["joint"] < 0.5 and m["vel"] < 0.6 and m["seg"] < 0.15):
        misses.append(f"joint {m['joint']} (< 0.5), velocity {m['vel']} "
                      f"(< 0.6), limb {m['seg']} (< 0.15)")
    if misses:
        _fail("long horizon: " + "; ".join(misses))
    return counts


def _phase(name, fn, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {name} {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _path_phases(smi: str, frames, twc, cli):
    """Render the other scenes (phase 14a's CLI runs meanwhile), then drive
    every main path with the kernels' launches recorded by shape.  Phases
    mapping and human get the frames quantized to uint8, as the drivers
    read them, so that their Systems are the drivers' in-memory twins.
    Returns the launches summed over the paths, and the loop closer's
    snapshot and extractor for phase loop replay."""
    crowd, crowd_twc = _phase("render crowd-27", _crowd_frames, N_CROWD)
    orbit, orbit_twc = _phase("render orbit-84", _orbit_frames, N_ORBIT)
    long_world, long_frames, long_twc = _phase("render long-110",
                                               _long_horizon_frames)
    memory = {}
    with _path_recording():
        _phase("slice", phase_slice, smi, frames, twc)
        launches = _phase("mapping", phase_mapping, smi,
                          [_twin(d) for d in frames], twc, memory)
        counts = [_phase("human", phase_human, smi,
                         [_twin(d) for d in crowd], crowd_twc, memory),
                  _phase("reloc", phase_reloc, smi, frames, twc)]
        loop, snap, extractor, offline_loop = _phase(
            "loop", phase_loop, smi, orbit, orbit_twc)
        counts += [loop, _phase("map scale", phase_map_scale, smi),
                   _phase("online", phase_online, smi, orbit, orbit_twc,
                          crowd, crowd_twc, frames, twc, offline_loop),
                   _phase("drivers", phase_drivers, smi, frames, twc, crowd,
                          crowd_twc, memory, cli),
                   _phase("long horizon", phase_long_horizon, smi,
                          long_world, long_frames, long_twc)]
    for c in counts:
        launches = {k: launches[k] + c[k] for k in launches}
    return launches, (snap, extractor)


def main():
    t_start = time.perf_counter()
    smi = phase_environment()
    _phase("build", phase_build)
    if sys.argv[1:] == ["--profile"]:
        phase_profile(smi)
        return
    if sys.argv[1:]:
        _fail(f"usage: python3 chip_smoke.py [--profile], got {sys.argv[1:]}")
    frames, twc = _phase("render static-28", _bench_frames, N_FRAMES)
    with _kitti_cli(frames) as cli:
        launches, (snap, extractor) = _path_phases(smi, frames, twc, cli)
    rows = _phase("kernel", phase_kernel, smi)
    _phase("determinism", phase_determinism)
    _phase("loop replay", phase_loop_replay, snap, extractor)
    _phase("agreement", phase_cpu_agreement)
    print(f"[time] chip_smoke {time.perf_counter() - t_start:.1f} s",
          flush=True)

    import torch
    sources = {"hamming_matrix": ("airdos_tpu_torch/csrc/hamming.cu",
                                  "airdos_tpu/ops/pallas_kernels.py:43"),
               "hamming_matrix_batched": ("airdos_tpu_torch/csrc/hamming.cu",
                                          "airdos_tpu/ops/pallas_kernels.py:43"),
               "segment_sum": ("airdos_tpu_torch/csrc/segment_sum.cu",
                               "airdos_tpu/solvers/local_ba.py:119, "
                               "airdos_tpu/solvers/human_ba.py:271, "
                               "airdos_tpu/solvers/global_ba.py:83, "
                               "airdos_tpu/solvers/pose_graph.py:79")}
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                **rows[name]}
               for name, (source, replaces) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
