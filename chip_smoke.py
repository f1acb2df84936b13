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
4. mapping: System(cfg, device="cuda") over the same 28 frames with the
   budgets of bench.py's static configuration: every frame OK, >= 5
   keyframes inserted, ATE < 0.02 m, triangulation created points, the
   static BA solved at every keyframe after the third, batched Hamming
   launches on every keyframe frame after the first, 75 segment_sum
   launches per BA solve;
5. kernel: each kernel against its plain torch version, with per-call
   times of both (CUDA events, median of 20 samples of 10 back-to-back
   calls) and the kernel's device time (torch.profiler):
   - the 2-D Hamming kernel at 1536x1536, 2048x1536 and a ragged
     1500x1337 of random words: exact equality;
   - every kernel at every shape phases 3 and 4 launched it with, on the
     first inputs the path gave it at that shape (recorded while the paths
     ran): Hamming exact, batched Hamming (triangulation B=4 x 1536x1536,
     fusion B=9 x 2048x1536 at this budget) exact, segment_sum bit-equal
     to its plain version (index_add_) on a CPU copy and two launches
     bit-equal to each other;
6. determinism: two card runs of the mapping System on the small camera
   over 8 frames give byte-identical TUM and KF/MP/Match dumps;
7. agreement: the mapping System on the small camera over 6 frames on the
   CPU (plain versions) and on the card: the same branches and keyframes,
   poses within 5 mm / 1e-3.

Each path's kernel launch counts are set to 0 just before the path is
driven and read just after; launches made to compare a kernel with its
plain version are not counted.  The last lines are one JSON line listing
the kernels, the nvidia-smi line, and {"ok": true, "device": {...}}.
Exits non-zero, printing no result, on any failure, including when no
CUDA device is present.

With --profile, phases 1-2 run and then phase_profile instead of the rest:
synchronized stage timers over the 28 bench frames (tracking stages per
fused frame, triangulation / fusion / BA solve per keyframe) and a
torch.profiler trace of the last two frames; it checks nothing and prints
no result line.
"""
from __future__ import annotations

import collections
import contextlib
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

N_FRAMES = 28
SEED = 0
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
# kernel name -> {shape: [launches, first inputs]} on the main paths
_PATH: dict = {}


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
    the CUDA-event time of inner back-to-back calls, divided by inner.  A
    call whose host side outlasts its device work is timed by the host."""
    import torch
    fn()
    torch.cuda.synchronize()
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


def _device_ms(fn, kernel: str, reps: int = 20):
    """Mean device time (ms) of the kernels whose name holds `kernel` over
    reps calls of fn(), from torch.profiler's CUDA trace; None when the
    trace holds no such kernel."""
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

    def recorder(launch, name, shape_of):
        def record(*args):
            entry = _PATH.setdefault(name, {}).setdefault(shape_of(*args),
                                                          [0, None])
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


def phase_kernel(smi: str):
    """Each kernel against its plain version: the 2-D Hamming kernel at
    three fixed shapes of random words, then every kernel at every shape
    the main paths launched it with, on the first inputs the path gave it
    at that shape.  Returns per kernel (max abs err over all checks, ms,
    plain ms) at its most launched path shape."""
    import torch
    hk, _ = _counters()
    rng = np.random.default_rng(SEED)
    errs = {}
    for n, m in ((1536, 1536), (2048, 1536), (1500, 1337)):
        a, b = _words(rng, (n, 8)), _words(rng, (m, 8))
        got = hk.hamming_matrix(a, b)
        want = hk.hamming_matrix_ref(a, b)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if got.shape != (n, m) or not torch.equal(got, want):
            _fail(f"kernel != plain version at {n}x{m} (max abs err {err})")
        ms = _cuda_ms(lambda: hk.hamming_matrix(a, b))
        plain_ms = _cuda_ms(lambda: hk.hamming_matrix_ref(a, b))
        dev_ms = _device_ms(lambda: hk.hamming_matrix(a, b), "hamming_kernel")
        dev = f"{dev_ms:.4f} ms" if dev_ms is not None else "not measured"
        print(f"[kernel] hamming {n}x{m} random words: exact; per call kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms (CUDA events, median of "
              f"20 x 10 back-to-back calls); kernel device time {dev} "
              f"(torch.profiler, mean of 20) on {smi}", flush=True)

    out = {}
    for name, tag in (("hamming_matrix", "hamming_kernel"),
                      ("hamming_matrix_batched", "hamming_kernel"),
                      ("segment_sum", "segment_sum_kernel")):
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
            ms, plain_ms = _cuda_ms(kernel), _cuda_ms(plain)
            dev_ms = _device_ms(kernel, tag)
            if i == 0:
                out[name] = (ms, plain_ms)
            dev = f"{dev_ms:.4f} ms" if dev_ms is not None else "not measured"
            extra = ""
            if name == "segment_sum":
                longest = int(args[1].offsets.diff().max())
                extra = f"; longest segment {longest} rows"
                what = "bit-equal to the CPU plain version, deterministic"
            else:
                what = "exact"
            print(f"[kernel] {name} {_fmt_shape(name, shape)}, {n_launch} "
                  f"launches on the main paths, on the path's inputs: {what}; "
                  f"per call kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
                  f"kernel device time {dev}{extra} on {smi}", flush=True)
    return {name: (errs[name],) + times for name, times in out.items()}


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
    frames = [world.frame(i, Rwc[i], twc[i], i * 0.1, with_humans=False)
              for i in range(n)]
    print(f"[frames] rendered {n} frames 640x360 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return frames, twc


def _sync() -> None:
    import torch
    torch.cuda.synchronize()


def _run(slam, frames):
    """Track frames with a System; per frame (state, branch, seconds)."""
    per = []
    for data in frames:
        t0 = time.perf_counter()
        slam.track_stereo(data)
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


def phase_mapping(smi: str, frames, twc):
    """The offline System with the mapping pass at the bench budgets."""
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
               if p["d"]["segment_sum"] != 75 * p["solves"]]
    if seg_off:
        _fail(f"mapping: segment_sum launches != 75 per BA solve at frames "
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
    n_seg, seg_ms = kernel_ms("segment_sum_kernel")
    print(f"[profile] frames {N_FRAMES - 2}-{N_FRAMES - 1} under "
          f"torch.profiler: {len(evs) / 2:.0f} device kernels per frame, "
          f"device busy {busy_ms:.2f} ms per frame, wall {wall_ms:.2f} ms "
          f"per frame (the profiler slows the host), busy share "
          f"{busy_ms / wall_ms:.4f}; hamming_kernel {n_ham} launches, mean "
          f"device time {ham_ms}; segment_sum_kernel {n_seg} launches, mean "
          f"device time {seg_ms}; on {smi}")
    OUT_DIR.mkdir(exist_ok=True)
    out = OUT_DIR / "profile_slice.txt"
    ka = prof.key_averages()
    out.write_text(ka.table(sort_by="self_cuda_time_total", row_limit=40)
                   + "\n" + ka.table(sort_by="count", row_limit=25))
    print(f"[profile] tables in {out}", flush=True)


def main():
    smi = phase_environment()
    phase_build()
    if sys.argv[1:] == ["--profile"]:
        phase_profile(smi)
        return
    if sys.argv[1:]:
        _fail(f"usage: python3 chip_smoke.py [--profile], got {sys.argv[1:]}")
    frames, twc = _bench_frames(N_FRAMES)
    with _path_recording():
        phase_slice(smi, frames, twc)
        launches = phase_mapping(smi, frames, twc)
    rows = phase_kernel(smi)
    phase_determinism()
    phase_cpu_agreement()

    import torch
    sources = {"hamming_matrix": ("airdos_tpu_torch/csrc/hamming.cu",
                                  "airdos_tpu/ops/pallas_kernels.py:43"),
               "hamming_matrix_batched": ("airdos_tpu_torch/csrc/hamming.cu",
                                          "airdos_tpu/ops/pallas_kernels.py:43"),
               "segment_sum": ("airdos_tpu_torch/csrc/segment_sum.cu",
                               "airdos_tpu/solvers/local_ba.py:119")}
    kernels = []
    for name, (source, replaces) in sources.items():
        err, ms, plain_ms = rows[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
