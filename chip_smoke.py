"""Smoke test of airdos_tpu_torch on one NVIDIA GPU (sm_90a: H100 / H200).

    python3 chip_smoke.py              # the smoke test
    python3 chip_smoke.py --profile    # where a fused frame's time goes

Run from the repository root.  Phases, each of which fails the run:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions, whether nvcc is present; a CUDA device is required;
2. build: csrc/hamming.cu compiled with nvcc for sm_90a (build seconds);
3. kernel: the Hamming kernel against its plain torch version on the card
   at the tracking path's shapes (1536x1536, 2048x1536) and a ragged
   1500x1337, exact equality; time per call of both (CUDA events, median
   of 20 samples of 10 back-to-back calls) and the kernel's device time
   (torch.profiler);
4. slice: System(cfg, device="cuda").track_stereo over 28 bench frames of
   the synthetic world at the reference budget (640x360, 1500 ORB
   features, 8 levels): every frame OK, >= 5 keyframes, ATE < 0.02 m, and
   >= 3 Hamming kernel launches on every fused ("fast") frame; then a
   small-camera run on CPU and on the card whose branches and poses must
   agree.

The last lines are a JSON line per kernel, the nvidia-smi line, and
{"ok": true, "device": {...}}.  Exits non-zero, printing no result, on any
failure, including when no CUDA device is present.

With --profile, phases 1-2 run and then phase_profile instead of the rest:
synchronized stage timers and a torch.profiler trace of fused frames at
the bench size; it checks nothing and prints no result line.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

N_FRAMES = 28
SEED = 0


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
    from airdos_tpu_torch.ops import hamming_kernels as hk
    t0 = time.perf_counter()
    path = hk.build()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s",
          flush=True)


def phase_kernel(smi: str):
    import torch
    from airdos_tpu_torch.ops import hamming_kernels as hk
    rng = np.random.default_rng(SEED)
    rows = []
    for n, m in ((1536, 1536), (2048, 1536), (1500, 1337)):
        a = torch.from_numpy(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).cuda()
        b = torch.from_numpy(rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).cuda()
        got = hk.hamming_matrix(a, b)
        want = hk.hamming_matrix_ref(a, b)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if got.shape != (n, m) or not torch.equal(got, want):
            _fail(f"kernel != plain version at {n}x{m} (max abs err {err})")
        ms = _cuda_ms(lambda: hk.hamming_matrix(a, b))
        plain_ms = _cuda_ms(lambda: hk.hamming_matrix_ref(a, b))
        dev_ms = _device_ms(lambda: hk.hamming_matrix(a, b), "hamming_kernel")
        rows.append((n, m, err, ms, plain_ms))
        dev = f"{dev_ms:.4f} ms" if dev_ms is not None else "not measured"
        print(f"[kernel] hamming {n}x{m}: exact; per call kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms (CUDA events, median of 20 x 10 "
              f"back-to-back calls); kernel device time {dev} "
              f"(torch.profiler, mean of 20) on {smi}", flush=True)
    return rows


def _bench_config():
    from airdos_tpu_torch.config import SlamConfig
    from airdos_tpu_torch.io.synthetic import default_camera
    cfg = SlamConfig()
    cfg.camera = default_camera()
    cfg.orb.n_features = 1500
    cfg.orb.n_levels = 8
    cfg.device.max_keypoints = 2048
    cfg.device.max_local_points = 2048
    return cfg


def _small_config():
    from airdos_tpu_torch.config import SlamConfig
    from airdos_tpu_torch.io.synthetic import small_camera
    cfg = SlamConfig()
    cfg.camera = small_camera()
    cfg.orb.n_features = 600
    cfg.orb.n_levels = 4
    cfg.device.max_keypoints = 1024
    cfg.device.max_local_points = 1024
    return cfg


def _run(cfg, frames, device, hk=None):
    """Track frames; per frame (state, branch, seconds, kernel launches)."""
    import torch
    from airdos_tpu_torch.slam.system import System
    slam = System(cfg, device=device)
    per = []
    if hk is not None:
        hk.reset_launches()
    for data in frames:
        before = hk.launches() if hk is not None else 0
        t0 = time.perf_counter()
        slam.track_stereo(data)
        if device == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        after = hk.launches() if hk is not None else 0
        per.append((slam.tracking.state.name, slam.tracking.last_branch, dt,
                    after - before))
    slam.shutdown()
    return slam, per


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


def phase_slice(smi: str):
    from airdos_tpu_torch.io.tum import ate_rmse
    from airdos_tpu_torch.ops import hamming_kernels as hk

    frames, twc = _bench_frames(N_FRAMES)
    slam, per = _run(_bench_config(), frames, "cuda", hk)
    for i, (state, branch, dt, n_launch) in enumerate(per):
        print(f"[slice] frame {i:2d} {state} {branch:5s} {dt * 1e3:9.2f} ms "
              f"hamming launches {n_launch}")
    bad = [i for i, p in enumerate(per) if p[0] != "OK"]
    if bad:
        _fail(f"frames not OK: {bad}")
    fast = [p for p in per if p[1] == "fast"]
    if not fast:
        _fail("no frame took the fused (fast) branch")
    few = [i for i, p in enumerate(per) if p[1] == "fast" and p[3] < 3]
    if few:
        _fail(f"fast frames with < 3 Hamming kernel launches: {few}")
    n_kfs = slam.map.n_keyframes()
    if n_kfs < 5:
        _fail(f"only {n_kfs} keyframes")
    ts, R_est, t_est = slam.tracking.trajectory_tum()
    if t_est.shape != (N_FRAMES, 3) or not np.isfinite(t_est).all() \
            or not np.isfinite(R_est).all():
        _fail(f"trajectory shape {t_est.shape} or non-finite poses")
    ate = ate_rmse(t_est, twc[:len(t_est)])
    if not ate < 0.02:
        _fail(f"ATE {ate} m >= 0.02 m")
    ms_all = np.asarray([p[2] for p in per]) * 1e3
    ms_fast = np.asarray([p[2] for p in fast]) * 1e3
    total_launches = sum(p[3] for p in per)
    branches = [p[1] for p in per]
    print(f"[slice] branches {branches[0]} -> {branches[1]} -> "
          f"fast x{branches.count('fast')}; keyframes {n_kfs}; map points "
          f"{slam.map.n_points()}; ATE {ate:.6f} m; hamming launches "
          f"{total_launches}")
    print(f"[slice] per-frame ms all frames: median {np.median(ms_all):.2f} "
          f"p90 {np.percentile(ms_all, 90):.2f}; fast frames: median "
          f"{np.median(ms_fast):.2f} p90 {np.percentile(ms_fast, 90):.2f} "
          f"on {smi}", flush=True)
    stages = slam.profiler.report()
    print("[slice] host stages (median ms): " + ", ".join(
        f"{k} {v['median_s'] * 1e3:.2f}" for k, v in sorted(stages.items())))
    return total_launches


def phase_cpu_agreement():
    """The same small-camera frames through the plain CPU path and the card:
    the same branches and keyframes, poses within 5 mm / 1e-3 rad."""
    from airdos_tpu_torch.io.synthetic import SyntheticStereoWorld
    cfg = _small_config()
    world = SyntheticStereoWorld(seed=SEED, n_points=200, cam=cfg.camera)
    frames = [d for d, _, _ in world.sequence(6, dt=0.1, yaw_rate=0.008)]
    cpu, per_cpu = _run(_small_config(), frames, "cpu")
    gpu, per_gpu = _run(_small_config(), frames, "cuda")
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
    print(f"[agree] small camera, 6 frames: CPU and GPU branches equal, "
          f"max |dt| {dt:.2e} m, max |dR| {dR:.2e}", flush=True)


def phase_profile(smi: str):
    """Where a fused frame's time goes at the bench size: stage timers with
    a synchronize on both sides over fused frames 6-7, then torch.profiler
    over frames 8-9 (device kernels per frame, device busy time and share).
    The profiler's tables go to chiprun_out/profile_slice.txt."""
    import collections
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    import airdos_tpu_torch.slam.frame as frame_mod
    import airdos_tpu_torch.slam.fused as fused
    from airdos_tpu_torch.slam.system import System

    frames, _ = _bench_frames(10)
    slam = System(_bench_config(), device="cuda")
    acc = collections.defaultdict(list)

    def timed(name, fn):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            acc[name].append(time.perf_counter() - t0)
            return out
        return wrapped

    stages = [(slam.frontend, "_build_impl", "front end (both images, stereo)"),
              (frame_mod, "stereo_match", "  of which stereo match"),
              (fused, "match_last_frame", "motion-model match"),
              (fused, "match_local_points", "local-map match"),
              (fused, "pose_optimize", "pose LM")]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in stages]
    for obj, attr, name in stages:
        setattr(obj, attr, timed(name, getattr(obj, attr)))
    for d in frames[:6]:
        slam.track_stereo(d)
    acc.clear()
    t0 = time.perf_counter()
    branches = []
    for d in frames[6:8]:
        slam.track_stereo(d)
        branches.append(slam.tracking.last_branch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 2 * 1e3
    for obj, attr, fn in saved:
        setattr(obj, attr, fn)
    print(f"[profile] frames 6-7 ({', '.join(branches)}), synchronized stage "
          f"timers, ms per frame on {smi}:")
    for _, _, name in stages:
        v = acc[name]
        print(f"[profile]   {name:32s} calls {len(v) / 2:.1f}  "
              f"ms {sum(v) / 2 * 1e3:8.2f}")
    print(f"[profile]   {'frame total (with the syncs)':32s} {'':9s}  "
          f"ms {wall_ms:8.2f}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for d in frames[8:10]:
            slam.track_stereo(d)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 2 * 1e3
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in evs) / 2 / 1e3
    ham = [e.time_range.elapsed_us() for e in evs
           if "hamming_kernel" in e.name]
    ham_ms = f"{sum(ham) / len(ham) / 1e3:.4f} ms" if ham else "not measured"
    print(f"[profile] frames 8-9 under torch.profiler: {len(evs) / 2:.0f} "
          f"device kernels per frame, device busy {busy_ms:.2f} ms per frame, "
          f"wall {wall_ms:.2f} ms per frame (the profiler slows the host), "
          f"busy share {busy_ms / wall_ms:.4f}; hamming_kernel {len(ham)} "
          f"launches, mean device time {ham_ms}; on {smi}")
    out = Path(__file__).resolve().parent / "chiprun_out" / "profile_slice.txt"
    out.parent.mkdir(exist_ok=True)
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
    rows = phase_kernel(smi)
    launches = phase_slice(smi)
    phase_cpu_agreement()

    import torch
    _, _, _, ms, plain_ms = rows[0]          # 1536 x 1536, the stereo shape
    print(json.dumps({"kernels": [{
        "name": "hamming_matrix", "route": "cuda",
        "source": "airdos_tpu_torch/csrc/hamming.cu",
        "replaces": "airdos_tpu/ops/pallas_kernels.py:43",
        "launches": launches,
        "max_abs_err": max(r[2] for r in rows),
        "ms": ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
