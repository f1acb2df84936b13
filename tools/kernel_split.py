"""Where a launch of pose_lm, select, orb_desc, static_edge_blocks,
fast_nms, pyramid, landmark_reduce, landmark_backsub, human_edge_blocks,
stereo_sad, patch_disparity, schur_point or schur_camera spends its time
on the card, from clock64() stamps in an instrumented copy of the
kernel's source.

    python3 tools/kernel_split.py [--parent DIR] [--only KERNEL ...]

Run from the repository root on a CUDA machine.  The copies are written at
run time into airdos_tpu_torch/_build/split/ (the kernels in csrc/ carry no
stamps): each stamp is inserted after a fixed line of the source, the copy
is built with the port's nvcc command and launched through its own C entry
point on the inputs below, and the stamps are read once a launch.

- pose_lm (csrc/pose_lm.cu) at N 1536 (200 mono edges, prior off) and N
  640: cycles a step in the block's own pass, the wait for its block's
  other warps, the exchange of the sums between the cluster's blocks, the
  LM step's tail and the barrier after it (the leader block's thread 0);
- select (csrc/select.cu) at 8 levels of a 640x360 textured image (1500
  features): cycles of level 0's leader in the scan with the two cluster
  barriers, the ranks, the sort and the slots;
- orb_desc (csrc/orb_desc.cu) on that image's selected keypoints, at
  level 0 (326 keypoints) and over the 8 levels in one launch: cycles a
  warp (lane 0's, the mean over the launch's warps) in the disc loads and
  moment sums, the reduction, the transcendentals and the sample rounds;
- static_edge_blocks (csrc/ba_static.cu) at E 8192 C 24 P 2048 in
  Gauss-Newton mode: cycles a warp's lane 0 in the gathers and
  projection, the block barrier, the float64 entries and the stores;
- fast_nms (csrc/fast.cu) on that image's 8 levels, at level 0 and over
  the 8 levels in one launch: cycles a warp in the tile loads, the scores
  and the NMS with the store (each part up to the block barrier after
  it);
- pyramid (csrc/pyramid.cu), the 8 levels of that image with a uint8
  mask (level 0 eroded 10 x 10) in one cooperative launch: cycles a warp
  a tile in the resize and halo with the mask's loads, the horizontal
  blur, the erosion's rows, the vertical blur with the stores and the
  erosion's columns with the mask's store, and the wait at each grid
  barrier;
- landmark_reduce and landmark_backsub (csrc/ba_points.cu) on a
  Gauss-Newton step's point sums of that static problem (P 2048 C 24, as
  the mapping phase launches them): cycles a warp's lane 0 in the
  reduce's inverses with the barrier, its rows' loads, products and
  stores, and in the back-substitution's loads with dx_c's staging, the
  camera sums, the tree and the finish;
- human_edge_blocks (csrc/ba_human.cu) in Gauss-Newton mode at the
  crowd-27 flagship's 896 / 896 / 280 edges on random state: cycles a
  warp's lane 0 in the gathers, projection and A staged, the block
  barrier, the float64 entries and the stores;
- stereo_sad (csrc/stereo_sad.cu) at 1536 keypoints over 8 levels of
  a 640x360 texture and its copy shifted 7 px: cycles a keypoint's lane 0
  in the header's loads, the staging of its windows, the SAD sums and the
  finish (minimum, parabola, tests, stores);
- schur_camera and schur_point (csrc/ba_global.cu) on seeded reduced
  camera systems at the map scale's (C 1000, P 100,000, E 298,380),
  pillar's (C 64, P 8192, E 45,000), the online pillar's (C 32, P 4096,
  E 16,384), a map-scale mesh rank's (E 74,595) and the dry run's rank's
  (C 4, P 32, E 64) sizes: cycles a camera's warp (lane 0) in the
  walk's loads, the rows' y, the chain of adds with Ap and q, the wait
  at the grid barriers and the update's three parts, and a point warp's
  lane 0 in the staging and the gathers with products; with --parent,
  the parent's design (a block a camera: loads and y, the six threads'
  chain, Ap, q and the counter, the last block's update; a thread a
  point: its walk) on the same inputs, each after one CG iteration
  bit-equal to the plain versions, and both sources' device times, also
  in raw mode; and the device times of a variant of schur_camera that
  sums a camera's rows over 32 lanes in float64 and a halving tree,
  rounded once (``camera_lanes``, held bit-equal to
  ``camera_sums_lanes_ref``), the order the shipped kernel does not take;
- patch_disparity (csrc/disparity.cu) at 40 torso probes on a 640x360
  8-bit texture and its copy shifted 13 px, and on the same texture in
  fractions: cycles a probe's thread 0 in the loads and shared stores to
  the barrier, the SAD sums to the barrier, and the first minimum with
  the parabola and the store.

Then the device time (chip_smoke.py's CUDA graph, L2 cold and hot) of the
shipped orb_desc (level 0; the 8 levels), static_edge_blocks (each mode),
fast_nms (level 0; the 8 levels), pyramid (the 8 levels, no mask and the
uint8 mask), landmark_reduce and landmark_backsub, and of the reduce with
its rows' loads issued before the inverses.  With --parent DIR (a `git
archive` of an older commit unpacked in DIR: the one before a kernel's
redesign), also its ba_points.cu (a thread a (point, camera, row) that recomputes
its point's inverse; a warp a point, lane 0 loading the finish's inputs
after the tree) on the same inputs: the split (reduce: inverse, loads,
rows and stores; back-substitution: loads with the camera sums, tree,
finish) and the device time of the unstamped source; and its
stereo_sad.cu and disparity.cu (a source unchanged from the parent's is
split once): the splits above and the device times at every path shape
(stereo: 1536 keypoints over 8 levels from 360x640 and 640 over 4 from
240x320; disparity: 40 probes at 360x640, 8-bit and fractions, and at
240x320).  The human
kernel's device times are its three modes' at 896 / 896 / 280 and 56 /
56 / 15 edges.  --only splits the named kernels alone (landmark: both).
Each copy's result is held against the plain version (pose_lm's R and t
within 1e-4; the others bit-equal); the split is printed beside the
launch's time (CUDA events) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# (cold, hot) device ms a call: chip_smoke.py's CUDA graph of 100 calls,
# each after a 64 MB L2-evicting write (cold), and back to back (hot)
from chip_smoke import _graph_ms, _outs  # noqa: E402

STAMPS_C = """
extern "C" int split_read(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_split, sizeof(g_split)));
}
extern "C" int split_reset() {
  unsigned long long z[8] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_split, z, sizeof(z)));
}
"""
HEAD = ("__device__ unsigned long long g_split[8];\n"
        "__shared__ long long s_split[8];\nnamespace {\n")


def _insert(src: str, edits) -> str:
    for anchor, text in edits:
        if src.count(anchor) != 1:
            raise SystemExit(f"kernel_split: anchor not found once: {anchor!r}")
        src = src.replace(anchor, text)
    return src + STAMPS_C


def pose_new(src: str) -> str:
    """csrc/pose_lm.cu of the cluster design: slots 0-4 per step, 5 steps,
    6 the launch."""
    return _insert(src, [
        ("namespace {\n", HEAD),
        ("  LmState s;\n", "  LmState s;\n  const long long t_kernel = clock64();\n"
         "  if (threadIdx.x == 0) for (int k = 0; k < 8; ++k) s_split[k] = 0;\n"),
        ("      ++tag;\n", "      ++tag;\n      const long long tA = clock64();\n"),
        ("          build_pass(edges, lo, hi, state, pose, cam, huber);\n"
         "      __syncthreads();\n",
         "          build_pass(edges, lo, hi, state, pose, cam, huber);\n"
         "      const long long tB = clock64();\n      __syncthreads();\n"
         "      const long long tC = clock64();\n      long long tD = tC;\n"),
        ("        tot[lane] = sum;\n", "        tot[lane] = sum;\n        tD = clock64();\n"),
        ("      __syncthreads();\n    }\n    const bool last",
         "      const long long tE = clock64();\n      __syncthreads();\n"
         "      if (rank == 0 && threadIdx.x == 0) {\n"
         "        s_split[0] += tB - tA; s_split[1] += tC - tB;\n"
         "        s_split[2] += tD - tC; s_split[3] += tE - tD;\n"
         "        s_split[4] += clock64() - tE; s_split[5] += 1;\n      }\n"
         "    }\n    const bool last"),
        ("    reinterpret_cast<int*>(out)[13] = s.work;\n  }\n}",
         "    reinterpret_cast<int*>(out)[13] = s.work;\n"
         "    s_split[6] = clock64() - t_kernel;\n"
         "    for (int k = 0; k < 8; ++k) g_split[k] += s_split[k];\n  }\n}"),
    ])


def select_new(src: str) -> str:
    """csrc/select.cu of the cluster design: slots 0-3 (scan with the
    cluster barriers, ranks, sort, slots) of level 0's leader, 4 launches."""
    return _insert(src, [
        ("namespace {\n", HEAD),
        ("  cluster_arrive_relaxed();               // this block has started\n",
         "  const long long t0 = clock64();\n"
         "  cluster_arrive_relaxed();               // this block has started\n"),
        ("  if (rank != 0) return;\n",
         "  if (rank != 0) return;\n  const long long t1 = clock64();\n"),
        ("                          : ~0ull;        // past the cells: sorted last\n"
         "  __syncthreads();\n",
         "                          : ~0ull;        // past the cells: sorted last\n"
         "  __syncthreads();\n  const long long t2 = clock64();\n"),
        ("    default: sort_keys_shared(keys, p);\n  }\n",
         "    default: sort_keys_shared(keys, p);\n  }\n"
         "  const long long t3 = clock64();\n"),
        ("    resp[slot] = r;\n  }\n}",
         "    resp[slot] = r;\n  }\n  __syncthreads();\n"
         "  if (tid == 0 && l == 0) {\n"
         "    g_split[0] += t1 - t0; g_split[1] += t2 - t1;\n"
         "    g_split[2] += t3 - t2; g_split[3] += clock64() - t3;\n"
         "    g_split[4] += 1;\n  }\n}"),
    ])


def _build(text: str, name: str, include=None, headers=None) -> ctypes.CDLL:
    """Build a copy of a source into _build/split/ with the port's nvcc
    command (the headers of csrc/, or of `include`: a parent's, or
    `headers` {name: text}: a variant's, copied into a directory of the
    copy's own) and load it."""
    from airdos_tpu_torch.ops import cuda_build
    out_dir = cuda_build.BUILD_DIR / "split"
    if include is not None or headers:
        out_dir = out_dir / name
        out_dir.mkdir(parents=True, exist_ok=True)
        if include is not None:
            for header in Path(include).glob("*.cuh"):
                (out_dir / header.name).write_text(header.read_text())
        for hname, htext in (headers or {}).items():
            (out_dir / hname).write_text(htext)
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    lib = out_dir / f"lib{name}.so"
    cmd = [cuda_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", str(cuda_build.CSRC), "-o", str(lib), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{res.stderr}")
    dll = ctypes.CDLL(str(lib))
    if hasattr(dll, "split_read"):
        dll.split_read.argtypes = [ctypes.c_void_p]
    return dll


def cuda_build_dir() -> Path:
    from airdos_tpu_torch.ops import cuda_build
    return cuda_build.BUILD_DIR


def _ptxas(text: str, name: str, include=None) -> None:
    """Print what `nvcc -Xptxas -v` reports of a source's kernels:
    registers, stack frame, spill stores and loads, shared memory (the
    headers of csrc/ or of the directory `include`)."""
    from airdos_tpu_torch.ops import cuda_build
    out_dir = cuda_build.BUILD_DIR / "split" / "ptxas" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    cmd = [cuda_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-Xptxas", "-v", "-c", "-o",
           str(out_dir / f"{name}.o"), "-I", str(include or cuda_build.CSRC),
           str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    lines = [ln.strip() for ln in res.stderr.splitlines()
             if "Compiling entry function" in ln or "registers" in ln
             or "spill" in ln or "Function properties" in ln]
    print(f"[ptxas] {name}:\n  " + "\n  ".join(lines), flush=True)


def _read(dll) -> list:
    acc = (ctypes.c_ulonglong * 8)()
    dll.split_read(acc)
    return list(acc)


def _pose_problem(n: int, n_mono: int, seed: int):
    import torch
    import airdos_tpu_torch.solvers.pose_opt as po
    from airdos_tpu_torch.geometry.se3 import se3_exp_np
    rng = np.random.default_rng(seed)
    fx = fy = 500.0
    cx, cy, bf = 320.0, 180.0, 250.0
    xw = rng.uniform([-5, -3, 4], [5, 3, 25], (n, 3))
    Rgt, tgt = se3_exp_np(np.array([0.1, -0.05, 0.2, 0.02, -0.03, 0.01]))
    xc = xw @ Rgt.T + tgt
    u = fx * xc[:, 0] / xc[:, 2] + cx
    v = fy * xc[:, 1] / xc[:, 2] + cy
    obs = np.stack([u, v, u - bf / xc[:, 2]], axis=1)
    obs[:, :2] += rng.normal(0, 0.3, (n, 2))
    out = rng.choice(n, n // 10, replace=False)
    obs[out, :2] += rng.uniform(20, 60, (len(out), 2))
    obs[:n_mono, 2] = -1.0
    R0, t0 = se3_exp_np(np.array([0.15, 0.0, 0.12, 0.03, -0.01, -0.005]))
    isig = 1.0 / 1.2 ** (2 * rng.integers(0, 4, n))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    prob = po.pack_problem(f(R0), f(t0), f(xw), f(obs), f(isig),
                           torch.as_tensor(rng.uniform(size=n) >= 0.05),
                           fx, fy, cx, cy, bf, 2.447749, 2.795483, 0.0, 0.0)
    return prob.pose0.cuda(), prob.edges.cuda(), prob.scalars


def _events_ms(fn, reps: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def split_pose(dll, name: str) -> None:
    import torch
    import airdos_tpu_torch.solvers.pose_opt as po
    entry = dll.airdos_pose_lm
    entry.argtypes = po._SIGNATURES["airdos_pose_lm"]
    entry.restype = ctypes.c_int
    for n, n_mono in ((1536, 200), (640, 60)):
        pose0, edges, scalars = _pose_problem(n, n_mono, n)
        out = torch.empty(16, device="cuda")
        inlier = torch.empty(n, dtype=torch.bool, device="cuda")

        def launch():
            err = entry(pose0.data_ptr(), edges.data_ptr(), out.data_ptr(),
                        inlier.data_ptr(), n, *scalars,
                        torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"{name}: launch failed, cudaError {err}")
        launch()
        want = po.pose_lm_ref(pose0, edges, scalars)
        torch.cuda.synchronize()
        err_r = float((out[:9].view(3, 3) - want.R).norm())
        err_t = float((out[9:12] - want.t).abs().max())
        if err_r > 1e-4 or err_t > 1e-4:
            raise SystemExit(f"{name} N={n}: R {err_r}, t {err_t} off the "
                             f"plain version")
        dll.split_reset()
        ms = _events_ms(launch)
        acc = _read(dll)
        reps = 21                          # _events_ms's warm-up and 20
        steps = acc[5]
        parts = (("own pass", acc[0]), ("block's warps", acc[1]),
                 ("exchange", acc[2]), ("tail", acc[3]), ("barrier", acc[4]))
        launch_cycles = acc[6]
        per = ", ".join(f"{k} {v / steps:.0f}" for k, v in parts)
        print(f"[split] {name} N={n} ({n_mono} mono, prior off): "
              f"{ms * 1e3:.1f} us a launch (CUDA events, 20 back to back), "
              f"{steps / reps:.0f} steps; cycles a step: {per}, sum "
              f"{sum(v for _, v in parts) / steps:.0f}; a launch "
              f"{launch_cycles / reps:.0f} cycles", flush=True)


def _texture(rng, h, w):
    img = rng.uniform(0, 255, (h + 8, w + 8))
    for _ in range(2):
        img = sum(img[dy:dy + img.shape[0] - 4, dx:dx + img.shape[1] - 4]
                  for dy in range(5) for dx in range(5)) / 25.0
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    return np.round(img).astype(np.float32)


def split_select(dll, name: str, fe) -> None:
    import torch
    import airdos_tpu_torch.ops.select as sk
    _, maps, quotas, cells, _, _ = fe
    entry = dll.airdos_select
    entry.argtypes = sk._SIGNATURES["airdos_select"]
    entry.restype = ctypes.c_int
    shipped, sk._kernel = sk._kernel, entry
    try:
        got = sk.select_keypoints_cuda(maps, quotas, cells, 12.0)
        want = sk.select_keypoints_ref(maps, quotas, cells, 12.0)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"{name}: not bit-equal to the plain version")
        dll.split_reset()
        ms = _events_ms(lambda: sk.select_keypoints_cuda(maps, quotas, cells,
                                                         12.0))
    finally:
        sk._kernel = shipped
    acc = _read(dll)
    n = acc[4]
    parts = (("scan with the cluster barriers", acc[0]), ("ranks", acc[1]),
             ("sort", acc[2]), ("slots", acc[3]))
    print(f"[split] {name} 8 levels 360x640 to {tuple(maps[-1].shape)}, "
          f"{sum(quotas)} slots: {ms * 1e3:.1f} us a launch (CUDA events, "
          f"20 back to back); level 0's leader, cycles: "
          + ", ".join(f"{k} {v / n:.0f}" for k, v in parts), flush=True)


# a warp's stamps summed over the launch's warps: lane 0 of every warp
# adds its intervals and a count into g_split
WARP_HEAD = "__device__ unsigned long long g_split[8];\nnamespace {\n"


def _warp_sums(cond: str, stamps) -> str:
    """`if (cond) { g_split[k] += stamps[k + 1] - stamps[k] ...; count }`."""
    adds = "".join(f"    atomicAdd(&g_split[{k}], static_cast<unsigned long "
                   f"long>({b} - {a}));\n"
                   for k, (a, b) in enumerate(zip(stamps, stamps[1:])))
    return (f"  if ({cond}) {{\n{adds}    atomicAdd(&g_split[7], 1ull);\n"
            f"  }}\n")


def _entry(dll, name: str, argtypes):
    fn = getattr(dll, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _front_end():
    """Level images, blurs, detection maps, quotas, cells and the selected
    keypoints (xs, ys of every slot) of 8 levels of a 640x360 textured
    image at 1500 features, through the port's kernels."""
    import torch
    from airdos_tpu_torch.features.orb import (MIN_BORDER, _cell_size_for,
                                               level_quotas)
    from airdos_tpu_torch.ops import fast, pyramid, select
    img = torch.from_numpy(_texture(np.random.default_rng(5), 360, 640))
    pyr = pyramid.build_pyramid(img.cuda(), None, 8, 1.2)
    maps = fast.fast_nms_levels(pyr.images, pyr.masks, 7.0, 16)
    quotas = level_quotas(1500, 8, 1.2)
    cells = [_cell_size_for(s.shape[0] - 2 * MIN_BORDER,
                            s.shape[1] - 2 * MIN_BORDER, q)
             for s, q in zip(maps, quotas)]
    xs, ys, _ = select.select_keypoints(maps, quotas, cells, 12.0)
    return pyr, maps, quotas, cells, xs, ys


def _level_slots(quotas):
    out, first = [], 0
    for q in quotas:
        out.append(slice(first, first + q))
        first += q
    return out


def _orb_check(got, pyr, quotas, xs, ys, levels, name):
    import torch
    from airdos_tpu_torch.ops import orb_kernels as ok
    slots = _level_slots(quotas)
    torch.cuda.synchronize()
    for (ang, desc), lvl in zip(got, levels):
        want = ok.orb_describe_ref(pyr.images[lvl], pyr.blurred[lvl],
                                   xs[slots[lvl]], ys[slots[lvl]])
        if not (torch.equal(ang, want[0]) and torch.equal(desc, want[1])):
            raise SystemExit(f"{name} level {lvl}: not bit-equal to the "
                             f"plain version")


ORB_PARTS = ("disc loads", "reduction", "transcendentals", "sample rounds")


def _print_split(name: str, what: str, ms: float, acc, parts) -> None:
    n = max(acc[7], 1)
    per = ", ".join(f"{k} {acc[i] / n:.0f}" for i, k in enumerate(parts))
    total = sum(acc[i] for i in range(len(parts))) / n
    print(f"[split] {name} {what}: {ms * 1e3:.1f} us a launch (CUDA events, "
          f"20 back to back; the stamped copy); cycles a warp (lane 0, mean "
          f"of {n // 21} warps a launch): {per}, sum {total:.0f}", flush=True)


def _static_problem(rng, E=8192, C=24, P=2048):
    """A local BA's edge table as the mapping phase builds it: C cameras
    along a path, P points in front of them, E observations (30% mono),
    observed with pixel noise, a tenth of them padding (inactive)."""
    import torch
    from airdos_tpu_torch.geometry.se3 import se3_exp_np
    Rs, ts = [], []
    for c in range(C):
        R, t = se3_exp_np(np.array([0.0, 0.0, -0.2 * c,
                                    0.01 * c, -0.02 * c, 0.005 * c]))
        Rs.append(R)
        ts.append(t)
    R = np.asarray(Rs, np.float32)
    t = np.asarray(ts, np.float32)
    pts = rng.uniform([-6, -3, 3], [6, 3, 30], (P, 3)).astype(np.float32)
    e_cam = rng.integers(0, C, E).astype(np.int32)
    e_pt = rng.integers(0, P, E).astype(np.int32)
    xc = np.einsum("eij,ej->ei", R[e_cam], pts[e_pt]) + t[e_cam]
    fx, fy, cx, cy, bf = CAM_BA
    z = np.maximum(xc[:, 2], 0.5)
    obs = np.stack([fx * xc[:, 0] / z + cx, fy * xc[:, 1] / z + cy,
                    fx * xc[:, 0] / z + cx - bf / z], 1)
    obs += rng.normal(0, 1.5, obs.shape)
    obs[rng.random(E) < 0.3, 2] = -1.0
    info = (1.0 / 1.44 ** rng.integers(0, 8, E)).astype(np.float32)
    active = (rng.random(E) > 0.1).astype(np.float32)
    arrays = (R, t, pts, e_cam, e_pt, obs.astype(np.float32), info, active)
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


CAM_BA = (500.0, 500.0, 320.0, 180.0, 250.0)     # fx, fy, cx, cy, bf


def _static_check(got, args, mode, name):
    import torch
    from airdos_tpu_torch.ops import ba_static as bs
    want = bs.static_edges_ref(*args, CAM_BA, 1.0, True, mode)
    if mode == bs.COST_SUM:
        want = (want,)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        same = (a.view(torch.int32) == b.view(torch.int32)) | \
            (torch.isnan(a) & torch.isnan(b))
        if not bool(same.all()):
            raise SystemExit(f"{name}: not bit-equal to the plain version")


def orb_new(src: str) -> str:
    """csrc/orb_desc.cu of the all-levels design: slots 0-3 per warp as in
    orb_parent (the disc slot from the warp's start: the pattern loads,
    the level lookup and the disc rows in flight), 7 warps."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  if (kp >= lv.total) return;  // the whole warp\n",
         "  if (kp >= lv.total) return;  // the whole warp\n"
         "  const long long t0 = clock64();\n"),
        ("      m01 += static_cast<double>(dy) * pv;\n    }\n  }\n",
         "      m01 += static_cast<double>(dy) * pv;\n    }\n  }\n"
         "  const long long t1 = clock64();\n"),
        ("  m01 = __shfl_sync(0xffffffffu, m01, 0);\n",
         "  m01 = __shfl_sync(0xffffffffu, m01, 0);\n"
         "  const long long t2 = clock64();\n"),
        ("  const float sa = sinf(r);\n",
         "  const float sa = sinf(r);\n  const long long t3 = clock64();\n"),
        ("  if (lane < 8) desc[static_cast<int64_t>(kp) * 8 + lane] = word;\n}\n",
         "  if (lane < 8) desc[static_cast<int64_t>(kp) * 8 + lane] = word;\n"
         "  const long long t4 = clock64();\n"
         + _warp_sums("lane == 0", ["t0", "t1", "t2", "t3", "t4"]) + "}\n"),
    ])


def static_new(src: str) -> str:
    """csrc/ba_static.cu of the lanes-an-edge design, Gauss-Newton mode:
    slots 0-3 per warp's lane 0 (the gathers and projection with A staged,
    the block barrier, the float64 entries, the barrier and the 16-byte
    stores), 7 warps."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  if (threadIdx.x < kLanes * kSlots) plan_s[threadIdx.x] = "
         "plan.word[threadIdx.x];\n",
         "  const long long t0 = clock64();\n"
         "  if (threadIdx.x < kLanes * kSlots) plan_s[threadIdx.x] = "
         "plan.word[threadIdx.x];\n"),
        ("  __syncthreads();\n  if (i < n) {\n    const float* a = a_s[le];\n",
         "  const long long t1 = clock64();\n  __syncthreads();\n"
         "  const long long t2 = clock64();\n"
         "  if (i < n) {\n    const float* a = a_s[le];\n"),
        ("  __syncthreads();\n  copy_out(cam + 42",
         "  const long long t3 = clock64();\n  __syncthreads();\n"
         "  copy_out(cam + 42"),
        ("  copy_out(pc + 18 * int64_t{first}, pc_s, 18 * nb);\n}\n",
         "  copy_out(pc + 18 * int64_t{first}, pc_s, 18 * nb);\n"
         "  const long long t4 = clock64();\n"
         + _warp_sums("(threadIdx.x & 31) == 0 && i < n",
                      ["t0", "t1", "t2", "t3", "t4"]) + "}\n"),
    ])


def _bind(dll, signatures) -> None:
    for name, argtypes in signatures.items():
        _entry(dll, name, argtypes)


def split_orb_new(fe) -> None:
    """This orb_desc: the stamped copy at level 0 alone and over the 8
    levels in one launch, then the shipped kernel's device time."""
    import torch
    from airdos_tpu_torch.ops import orb_kernels as ok
    pyr, _, quotas, _, xs, ys = fe
    every = list(range(len(quotas)))
    src = (REPO / "airdos_tpu_torch" / "csrc" / "orb_desc.cu").read_text()
    dll = _build(orb_new(src), "orb_desc_split")
    _bind(dll, ok._SIGNATURES)
    n0 = quotas[0]
    one = (lambda: [ok.orb_describe_cuda(pyr.images[0], pyr.blurred[0],
                                         xs[:n0], ys[:n0])])
    levels = (lambda: ok.orb_describe_levels_cuda(pyr.images, pyr.blurred,
                                                  xs, ys, quotas))
    shipped, ok._lib = ok._lib, dll
    try:
        _orb_check(one(), pyr, quotas, xs, ys, [0], "orb_desc")
        want = ok.orb_describe_levels_ref(pyr.images, pyr.blurred, xs, ys,
                                          quotas)
        got = levels()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit("orb_desc (8 levels): not bit-equal to the "
                             "plain version")
        for what, fn in ((f"level 0 360x640, {n0} keypoints", one),
                         (f"8 levels, {sum(quotas)} slots, one launch",
                          levels)):
            dll.split_reset()
            ms = _events_ms(fn)
            _print_split("orb_desc", what, ms, _read(dll), ORB_PARTS)
    finally:
        ok._lib = shipped
    c0, h0 = _graph_ms(one)
    c8, h8 = _graph_ms(levels)
    _orb_check(one(), pyr, quotas, xs, ys, [0], "orb_desc")
    print(f"[time] orb_desc (a launch an image): level 0 cold {c0:.4f} ms "
          f"(hot {h0:.4f}); the 8 levels in one launch cold {c8:.4f} ms "
          f"(hot {h8:.4f}), {sum(quotas)} slots", flush=True)


def split_static_new(args) -> None:
    """This static_edge_blocks at E 8192 C 24 P 2048: the stamped copy in
    Gauss-Newton mode, then the shipped kernel's device time in each
    mode."""
    from airdos_tpu_torch.ops import ba_static as bs
    dll = _build(static_new((REPO / "airdos_tpu_torch" / "csrc" /
                             "ba_static.cu").read_text()), "ba_static_split")
    stamped = _entry(dll, "airdos_static_edges",
                     bs._SIGNATURES["airdos_static_edges"])

    def run(mode):
        return lambda: bs.static_edges_cuda(*args, CAM_BA, 1.0, True, mode)
    shipped, bs._kernel = bs._kernel, stamped
    try:
        _static_check(run(bs.ROWS)(), args, bs.ROWS, "static_edge_blocks")
        dll.split_reset()
        ms = _events_ms(run(bs.ROWS))
        _print_split("static_edge_blocks", "E 8192 C 24 P 2048, Gauss-Newton "
                     "mode", ms, _read(dll),
                     ("gathers and projection", "block barrier",
                      "float64 entries", "barrier and stores"))
    finally:
        bs._kernel = shipped
    for mode in (bs.ROWS, bs.COST, bs.COST_SUM):
        got = run(mode)()
        _static_check(got if mode != bs.COST_SUM else (got,), args, mode,
                      f"static_edge_blocks mode {mode}")
    times = [_graph_ms(run(mode)) for mode in (bs.ROWS, bs.COST,
                                               bs.COST_SUM)]
    print("[time] static_edge_blocks (lanes an edge) E 8192 C 24 P 2048: "
          + "; ".join(f"{what} cold {c:.4f} ms (hot {h:.4f})"
                      for what, (c, h) in zip(
                          ("Gauss-Newton", "cost mode", "cost sum"), times)),
          flush=True)



FAST_PARTS = ("tile loads", "scores", "NMS and store")


def fast_new(src: str) -> str:
    """csrc/fast.cu of the all-levels design: slots 0-2 per warp (the
    image and mask tiles to the barrier, the scores to the barrier, the
    NMS and the store), 7 warps."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  load_tile(simg, lv.img[l], kImg, y0 - kHalo, x0 - kHalo, h, w, tid);\n",
         "  const long long t0 = clock64();\n"
         "  load_tile(simg, lv.img[l], kImg, y0 - kHalo, x0 - kHalo, h, w, tid);\n"),
        ("  load_tile(smask, lv.mask[l], kSc, y0 - 1, x0 - kHalo, h, w, tid);\n"
         "  __syncthreads();\n",
         "  load_tile(smask, lv.mask[l], kSc, y0 - 1, x0 - kHalo, h, w, tid);\n"
         "  __syncthreads();\n  const long long t1 = clock64();\n"),
        ("    ssc[ly][lx] = t;\n  }\n  __syncthreads();\n",
         "    ssc[ly][lx] = t;\n  }\n  __syncthreads();\n"
         "  const long long t2 = clock64();\n"),
        ("    out[static_cast<int64_t>(gy) * w + gx] = c > m ? c : 0.0f;\n  }\n}\n",
         "    out[static_cast<int64_t>(gy) * w + gx] = c > m ? c : 0.0f;\n  }\n"
         "  const long long t3 = clock64();\n"
         + _warp_sums("threadIdx.x == 0", ["t0", "t1", "t2", "t3"]) + "}\n"),
    ])


def _fast_check(got, images, masks, name):
    import torch
    from airdos_tpu_torch.ops import fast
    want = fast.fast_nms_levels_ref(images, masks, 7.0, 16)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise SystemExit(f"{name}: not bit-equal to the plain version")


def split_fast(pyr) -> None:
    """fast_nms on the 8 levels: the stamped copy at level 0 and in one
    launch, then the unstamped source's device times."""
    from airdos_tpu_torch.ops import fast
    images, masks = list(pyr.images), list(pyr.masks)
    src = (REPO / "airdos_tpu_torch" / "csrc" / "fast.cu").read_text()
    dll = _build(fast_new(src), "fast_split")
    _bind(dll, fast._SIGNATURES)
    one = (lambda: [fast.fast_nms_cuda(images[0], masks[0], 7.0, 16)])
    levels = (lambda: fast.fast_nms_levels_cuda(images, masks, 7.0, 16))
    shipped, fast._lib = fast._lib, dll
    try:
        _fast_check(one(), images[:1], masks[:1], "fast_nms")
        _fast_check(levels(), images, masks, "fast_nms")
        for what, fn in (("level 0 360x640", one),
                         ("8 levels in one launch", levels)):
            dll.split_reset()
            ms = _events_ms(fn)
            _print_split("fast_nms", what, ms, _read(dll), FAST_PARTS)
    finally:
        fast._lib = shipped
    c0, h0 = _graph_ms(one)
    c8, h8 = _graph_ms(levels)
    _fast_check(levels(), images, masks, "fast_nms")
    print(f"[time] fast_nms (a launch an image): level 0 cold {c0:.4f} ms "
          f"(hot {h0:.4f}); the 8 levels in one launch cold {c8:.4f} ms "
          f"(hot {h8:.4f})", flush=True)


PYR_PARTS = ("resize, halo and mask loads", "horizontal blur",
             "erosion rows", "vertical blur and stores",
             "erosion columns and mask store")
BARRIERS_C = """
extern "C" int split_read_barriers(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_bar, sizeof(g_bar)));
}
extern "C" int split_reset_barriers() {
  unsigned long long z[16] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_bar, z, sizeof(z)));
}
"""


def pyramid_new(src: str) -> str:
    """csrc/pyramid.cu of the cooperative design: slots 0-4 per warp a
    tile (the resized tile and halo, the resized mask or the mask tile, to
    the barrier; horizontal blur; erosion rows to the barrier; vertical
    blur with the stores; erosion columns and the mask's store), 7 tiles;
    g_bar[l] the cycles warps wait at the barrier after phase l,
    g_bar[15] the waits."""
    return _insert(src, [
        ("namespace {\n", "__device__ unsigned long long g_bar[16];\n"
         + WARP_HEAD),
        ("  const bool erode = L.level0 && L.mask_kind != kNoMask;\n"
         "  const int h = L.h, w = L.w;\n",
         "  const bool erode = L.level0 && L.mask_kind != kNoMask;\n"
         "  const int h = L.h, w = L.w;\n  const long long t0 = clock64();\n"),
        ("s.sm[i / mext][i - (i / mext) * mext] = mt[r];\n    }\n  }\n"
         "  __syncthreads();\n",
         "s.sm[i / mext][i - (i / mext) * mext] = mt[r];\n    }\n  }\n"
         "  __syncthreads();\n  const long long t1 = clock64();\n"),
        ("    s.sh[ly][lx] = acc;\n  }\n",
         "    s.sh[ly][lx] = acc;\n  }\n  const long long t2 = clock64();\n"),
        ("      s.smr[ly][lx] = q;\n    }\n  }\n  __syncthreads();\n",
         "      s.smr[ly][lx] = q;\n    }\n  }\n  __syncthreads();\n"
         "  const long long t3 = clock64();\n"),
        ("    if (!L.level0) L.img[at] = s.sr[ly + kHalo][cx + kHalo];\n  }\n",
         "    if (!L.level0) L.img[at] = s.sr[ly + kHalo][cx + kHalo];\n  }\n"
         "  const long long t4 = clock64();\n"),
        ("L.mask[static_cast<int64_t>(gy) * w + gx] = m[r];\n  }\n}\n",
         "L.mask[static_cast<int64_t>(gy) * w + gx] = m[r];\n  }\n"
         "  const long long t5 = clock64();\n"
         + _warp_sums("threadIdx.x == 0",
                      ["t0", "t1", "t2", "t3", "t4", "t5"]) + "}\n"),
        ("    if (l + 1 < p.n_levels) grid.sync();   // level l whole before l + 1\n",
         "    if (l + 1 < p.n_levels) {\n"
         "      const long long tb = clock64();\n      grid.sync();\n"
         "      if (threadIdx.x == 0) {\n"
         "        atomicAdd(&g_bar[l], static_cast<unsigned long long>("
         "clock64() - tb));\n"
         "        atomicAdd(&g_bar[15], 1ull);\n      }\n    }\n"),
    ]) + BARRIERS_C


def _pyramid_inputs():
    """The 640x360 texture and a uint8 mask with a blanked box, on the
    card."""
    import torch
    img = _texture(np.random.default_rng(5), 360, 640)
    mask = np.ones((360, 640), np.uint8)
    mask[90:180, 213:320] = 0
    return torch.from_numpy(img).cuda(), torch.from_numpy(mask).cuda()


def _pyramid_check(levels, img, mask, name):
    import torch
    from airdos_tpu_torch.ops import pyramid
    want = pyramid.build_pyramid(img.cpu(), None if mask is None
                                 else mask.cpu(), 8, 1.2)
    torch.cuda.synchronize()
    for lvl, got in enumerate(levels):
        for part in range(3):
            if not torch.equal(got[part].cpu(), want[part][lvl]):
                raise SystemExit(f"{name} level {lvl}: not bit-equal to the "
                                 f"plain version")


def split_pyramid(img, mask) -> None:
    """pyramid on the 8 levels with the uint8 mask: the stamped copy's
    cooperative launch, then the unstamped source's device times with and
    without the mask."""
    import torch
    from airdos_tpu_torch.ops import pyramid
    src = (REPO / "airdos_tpu_torch" / "csrc" / "pyramid.cu").read_text()
    dll = _build(pyramid_new(src), "pyramid_split")
    _bind(dll, pyramid._SIGNATURES)
    dll.airdos_pyramid_error_name.argtypes = [ctypes.c_int]
    dll.airdos_pyramid_error_name.restype = ctypes.c_char_p
    dll.split_read_barriers.argtypes = [ctypes.c_void_p]
    shipped = pyramid._lib, dict(pyramid._residency)
    pyramid._lib = dll
    pyramid._residency.clear()      # the stamped copy's own residency
    run = (lambda: pyramid.build_pyramid_cuda(img, mask, 8, 1.2))
    try:
        got = run()
        _pyramid_check(list(zip(*got[:3])), img, mask, "pyramid")
        shapes = pyramid.level_shapes(*img.shape, 8, 1.2)
        grid = pyramid.cooperative_grid(img.device, shapes)
        dll.split_reset()
        dll.split_reset_barriers()
        ms = _events_ms(run)
        acc = _read(dll)
        bar = (ctypes.c_ulonglong * 16)()
        dll.split_read_barriers(bar)
        _print_split("pyramid", f"8 levels from 360x640, uint8 mask, one "
                     f"cooperative launch of {grid} blocks", ms, acc,
                     PYR_PARTS)
        waits = max(bar[15], 1) // 7        # warps a barrier, over the runs
        print("[split] pyramid: cycles a warp waits at the grid barrier "
              "after each phase (lane 0, mean): " + ", ".join(
                  f"level {lvl} {bar[lvl] / waits:.0f}" for lvl in range(7)),
              flush=True)
    finally:
        pyramid._lib = shipped[0]
        pyramid._residency.clear()
        pyramid._residency.update(shipped[1])
    times = [_graph_ms(lambda m=m: pyramid.build_pyramid_cuda(img, m, 8, 1.2))
             for m in (None, mask)]
    _pyramid_check(list(zip(*run()[:3])), img, mask, "pyramid")
    torch.cuda.synchronize()
    print("[time] pyramid (one cooperative launch an image), the 8 levels: "
          + "; ".join(f"{what} cold {c:.4f} ms (hot {h:.4f})"
                      for what, (c, h) in zip(("no mask", "uint8 mask"),
                                              times)), flush=True)


LR_PARENT_PARTS = ("inverse", "loads issued", "rows and stores")
LR_PARTS = ("inverses and barrier", "loads issued", "rows", "stores")
LB_PARENT_PARTS = ("loads and camera sums", "tree", "finish")
LB_PARTS = ("loads issued, dx_c staging and barrier", "camera sums",
            "tree", "finish")
TREE = "#pragma unroll\n  for (int off = 16; off > 0; off /= 2)\n"
TREE_ADD = ("      acc[l] = dadd(acc[l], __shfl_down_sync(0xffffffffu, "
            "acc[l], off));\n")


def landmark_parent(src: str) -> str:
    """The parent's csrc/ba_points.cu (a thread a (point, camera, row),
    a warp a point): reduce slots 0-2 a warp's lane 0 (its point's
    inverse, the row's loads issued, the row's products and stores: the
    loads' arrival is in them); back-substitution slots 0-2 (the strided
    loads with the camera sums, the shuffle tree, lane 0's finish with
    its loads).  The two kernels are split one at a time."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  if (idx >= static_cast<int64_t>(P) * C * 6) return;\n",
         "  if (idx >= static_cast<int64_t>(P) * C * 6) return;\n"
         "  const long long t0 = clock64();\n"),
        ("  damped_inverse(pt_sums + 12 * static_cast<int64_t>(p), valid[p], "
         "*lam, hi);\n",
         "  damped_inverse(pt_sums + 12 * static_cast<int64_t>(p), valid[p], "
         "*lam, hi);\n  const long long t1 = clock64();\n"),
        ("  const double w0 = w[0], w1 = w[1], w2 = w[2];\n",
         "  const double w0 = w[0], w1 = w[1], w2 = w[2];\n"
         "  const long long t2 = clock64();\n"),
        ("dmul(w2, hi[6 + m])));\n}\n",
         "dmul(w2, hi[6 + m])));\n  const long long t3 = clock64();\n"
         + _warp_sums("(threadIdx.x & 31) == 0", ["t0", "t1", "t2", "t3"])
         + "}\n"),
        ("  if (p >= P) return;                        // the whole warp leaves\n",
         "  if (p >= P) return;                        // the whole warp leaves\n"
         "  const long long t0 = clock64();\n"),
        (TREE, "  const long long t1 = clock64();\n" + TREE),
        (TREE_ADD, TREE_ADD + "  const long long t2 = clock64();\n"),
        ("mul(__double2float_rn(d), v);\n    }\n  }\n}\n",
         "mul(__double2float_rn(d), v);\n    }\n  }\n"
         "  const long long t3 = clock64();\n"
         + _warp_sums("lane == 0", ["t0", "t1", "t2", "t3"]) + "}\n"),
    ])


def landmark_new(src: str) -> str:
    """This csrc/ba_points.cu: reduce slots 0-3 a warp's lane 0 (the
    block's inverses with the barrier, the rows' loads issued, the rows'
    products: the loads' arrival is in them, the stores); back-
    substitution slots 0-3 (the camera's loads issued and dx_c staged
    with the barrier, the camera sums: the loads' arrival is in them, the
    tree, lane 0's finish), at C 24 one pass."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  const int nr = min(kRowsAThread, n_rows - r0);   // this thread's rows\n",
         "  const int nr = min(kRowsAThread, n_rows - r0);   // this thread's rows\n"
         "  const long long t0 = clock64();\n"),
        ("  __syncthreads();\n  if (nr <= 0) return;\n",
         "  __syncthreads();\n  if (nr <= 0) return;\n"
         "  const long long t1 = clock64();\n"),
        ("  const int p0 = r0 / six_c;\n",
         "  const long long t2 = clock64();\n  const int p0 = r0 / six_c;\n"),
        ("  if (nr == kRowsAThread) {\n#pragma unroll\n    for (int j = 0; j < kF; "
         "j += 4)\n",
         "  const long long t3 = clock64();\n"
         "  if (nr == kRowsAThread) {\n#pragma unroll\n    for (int j = 0; j < kF; "
         "j += 4)\n"),
        ("      if (j < 3 * nr) aagg[3 * r0 + j] = a[j];\n  }\n}\n",
         "      if (j < 3 * nr) aagg[3 * r0 + j] = a[j];\n  }\n"
         "  const long long t4 = clock64();\n"
         + _warp_sums("(threadIdx.x & 31) == 0",
                      ["t0", "t1", "t2", "t3", "t4"]) + "}\n"),
        ("  const bool live = p < P;                   // a whole warp\n",
         "  const bool live = p < P;                   // a whole warp\n"
         "  const long long t0 = clock64();\n  long long t1 = t0, t2 = t0;\n"),
        ("    __syncthreads();\n    if (mine) {\n",
         "    __syncthreads();\n    t1 = clock64();\n    if (mine) {\n"),
        ("        acc[l] = dadd(acc[l], t);\n      }\n    }\n  }\n",
         "        acc[l] = dadd(acc[l], t);\n      }\n    }\n"
         "    t2 = clock64();\n  }\n"),
        (TREE_ADD, TREE_ADD + "  const long long t3 = clock64();\n"),
        ("      dx_p[3 * p + l] = mul(__double2float_rn(d), v);\n    }\n  }\n}\n",
         "      dx_p[3 * p + l] = mul(__double2float_rn(d), v);\n    }\n  }\n"
         "  const long long t4 = clock64();\n"
         + _warp_sums("live && lane == 0", ["t0", "t1", "t2", "t3", "t4"])
         + "}\n"),
    ])


def landmark_loads_first(src: str) -> str:
    """This csrc/ba_points.cu with the reduce's row loads (from `float
    w[kF];` to the rows' points) issued before the block's inverses, the
    order this source does not take."""
    start, anchor = "  float w[kF];\n", "  if (static_cast<int>(threadIdx.x) < n_pts) {\n"
    for a in (start, anchor):
        if src.count(a) != 1:
            raise SystemExit(f"kernel_split: anchor not found once: {a!r}")
    i = src.index(start)
    loads = src[i:src.index("  const int p0 = r0 / six_c;\n", i)]
    src = src.replace(loads, "")
    return src.replace(anchor, loads + anchor)


def _landmark_problem(rng):
    """The landmark kernels' inputs in a Gauss-Newton step of the static
    problem (E 8192 C 24 P 2048, the mapping phase's shape): the edges'
    rows summed by point and by (point, camera) as solvers/local_ba.py's
    schur_reduce sums them, the points that an active edge observes valid,
    lam 1e-3 and a camera step of a few millimetres."""
    import torch
    from airdos_tpu_torch.ops import ba_static as bs
    from airdos_tpu_torch.ops.segment_kernels import segment_sum
    from airdos_tpu_torch.solvers.local_ba import static_segments
    args = _static_problem(rng)
    R, _, pts, e_cam, e_pt, _, _, active = args
    C, P = R.shape[0], pts.shape[0]
    rows = bs.static_edges_cuda(*args, CAM_BA, 1.0, True, bs.ROWS)
    segs = static_segments(e_cam, e_pt, C, P, active > 0)
    pt_sums = segment_sum(rows.pt, segs.pt)
    wagg = segment_sum(rows.pc, segs.pc).reshape(P, C * 18)
    valid = pt_sums[:, 0] > 0
    lam = torch.tensor(1e-3, dtype=torch.float32, device="cuda")
    dx_c = torch.from_numpy(rng.normal(0, 3e-3, (C, 6)).astype(np.float32))
    return pt_sums, wagg, valid, lam, dx_c.cuda()


def _bits_check(got, want, name):
    """Each of a kernel's float32 outputs bit-equal to the plain
    version's (NaNs equal to NaNs)."""
    import torch
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        same = (a.view(torch.int32) == b.view(torch.int32)) | \
            (torch.isnan(a) & torch.isnan(b))
        if not bool(same.all()):
            raise SystemExit(f"{name}: not bit-equal to the plain version")


def _landmark_launchers(dll, problem, want):
    """reduce() and backsub() through a build's C entry points (the
    parent's take the same arguments) on the problem's inputs, the
    back-substitution on the plain Hpp^-1."""
    import torch
    pt_sums, wagg, valid, lam, dx_c = problem
    P, C = pt_sums.shape[0], wagg.shape[1] // 18
    from airdos_tpu_torch.ops import ba_points as bp
    red = _entry(dll, "airdos_landmark_reduce",
                 bp._SIGNATURES["airdos_landmark_reduce"])
    back = _entry(dll, "airdos_landmark_backsub",
                  bp._SIGNATURES["airdos_landmark_backsub"])
    hinv = torch.empty((P, 3, 3), device="cuda")
    aagg = torch.empty((P, C, 6, 3), device="cuda")
    dx_p = torch.empty((P, 3), device="cuda")
    stream = (lambda: torch.cuda.current_stream().cuda_stream)

    def reduce():
        err = red(pt_sums.data_ptr(), wagg.data_ptr(), valid.data_ptr(),
                  lam.data_ptr(), P, C, hinv.data_ptr(),
                  aagg.data_ptr(), stream())
        if err:
            raise SystemExit(f"landmark_reduce: cudaError {err}")
        return hinv, aagg

    def backsub():
        err = back(want[0].data_ptr(), pt_sums.data_ptr(), wagg.data_ptr(),
                   dx_c.data_ptr(), valid.data_ptr(), P, C, dx_p.data_ptr(),
                   stream())
        if err:
            raise SystemExit(f"landmark_backsub: cudaError {err}")
        return (dx_p,)
    return reduce, backsub


def split_landmark(parent, problem) -> None:
    """landmark_reduce and landmark_backsub at P 2048 C 24: the stamped
    copies (the parent's when given, then this one's), the unstamped
    sources' device times, and this reduce's with its rows' loads issued
    before the inverses; each result bit-equal to the plain versions."""
    from airdos_tpu_torch.ops import ba_points as bp
    pt_sums, wagg, valid, lam, dx_c = problem
    P, C = pt_sums.shape[0], wagg.shape[1] // 18
    want = bp.landmark_reduce_ref(pt_sums, wagg, valid, lam)
    want_dx = bp.landmark_backsub_ref(want[0], pt_sums, wagg, dx_c, valid)
    what = f"P {P} C {C}"
    this = REPO / "airdos_tpu_torch" / "csrc" / "ba_points.cu"
    srcs = [] if parent is None else [
        (" (parent)", (parent / "airdos_tpu_torch" / "csrc" /
                       "ba_points.cu").read_text(), landmark_parent,
         LR_PARENT_PARTS, LB_PARENT_PARTS)]
    srcs.append(("", this.read_text(), landmark_new, LR_PARTS, LB_PARTS))
    for label, text, stamp, lr_parts, lb_parts in srcs:
        tag = "parent" if label else "this"
        dll = _build(stamp(text), f"ba_points_{tag}_split")
        for name, fn, parts, check in zip(
                ("landmark_reduce", "landmark_backsub"),
                _landmark_launchers(dll, problem, want),
                (lr_parts, lb_parts), (want, (want_dx,))):
            _bits_check(fn(), check, name + label)
            dll.split_reset()                 # the slots: one kernel at a time
            ms = _events_ms(fn)
            _print_split(name + label, what, ms, _read(dll), parts)
        reduce, backsub = _landmark_launchers(
            _build(text, f"ba_points_{tag}"), problem, want)
        _bits_check(reduce(), want, "landmark_reduce" + label)
        _bits_check(backsub(), (want_dx,), "landmark_backsub" + label)
        (rc, rh), (bc, bh) = _graph_ms(reduce), _graph_ms(backsub)
        print(f"[time] landmark{label} {what}: reduce cold {rc:.4f} ms (hot "
              f"{rh:.4f}); backsub cold {bc:.4f} ms (hot {bh:.4f})",
              flush=True)
    reduce, _ = _landmark_launchers(
        _build(landmark_loads_first(this.read_text()), "ba_points_loads_first"),
        problem, want)
    _bits_check(reduce(), want, "landmark_reduce (loads first)")
    rc, rh = _graph_ms(reduce)
    print(f"[time] landmark_reduce {what}, its rows' loads issued before the "
          f"inverses: cold {rc:.4f} ms (hot {rh:.4f})", flush=True)


# ------------------------------------------- human_edge_blocks, stereo_sad

def _sources(parent, name: str):
    """[(label, source text)] of csrc/<name>: the parent's when given, then
    this tree's, unless it is the parent's unchanged (then split once)."""
    this = (REPO / "airdos_tpu_torch" / "csrc" / name).read_text()
    if parent is None:
        return [("", this)]
    old = (parent / "airdos_tpu_torch" / "csrc" / name).read_text()
    return [(" (parent)", old)] + ([] if old == this else [("", this)])


HU_PARTS = ("gathers, projection and A staged", "block barrier",
            "float64 entries", "barrier and stores")


def human_new(src: str) -> str:
    """This csrc/ba_human.cu (kLanes lanes an edge, a block of one
    family), Gauss-Newton mode: slots 0-3 a warp's lane 0 (the gathers,
    residual, Jacobian and weight with A staged, the block barrier, the
    float64 entries and their stores into shared memory, the barrier and
    the 16-byte stores), over the three families' blocks."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  if (threadIdx.x < kLanes * Fam::kSlots)\n",
         "  const long long t0 = clock64();\n"
         "  if (threadIdx.x < kLanes * Fam::kSlots)\n"),
        ("  __syncthreads();\n  if (i < n) {\n    // every entry first",
         "  const long long t1 = clock64();\n  __syncthreads();\n"
         "  const long long t2 = clock64();\n"
         "  if (i < n) {\n    // every entry first"),
        ("  __syncthreads();\n  copy_out(hout, h_s, Q * Q * nb, h_phase);\n"
         "  copy_out(bout, b_s, Q * nb, b_phase);\n}\n",
         "  const long long t3 = clock64();\n  __syncthreads();\n"
         "  copy_out(hout, h_s, Q * Q * nb, h_phase);\n"
         "  copy_out(bout, b_s, Q * nb, b_phase);\n"
         "  const long long t4 = clock64();\n"
         + _warp_sums("(threadIdx.x & 31) == 0 && i < n",
                      ["t0", "t1", "t2", "t3", "t4"]) + "}\n"),
    ])


def _human_this_launcher(dll, problem):
    """This tree's Gauss-Newton launch through ops/ba_human's wrapper, on
    a build's C entry point, with the problem's LaunchTables."""
    from airdos_tpu_torch.ops import ba_human as bh
    state, tb, act = problem
    entry = _entry(dll, "airdos_human_edges",
                   bh._SIGNATURES["airdos_human_edges"])
    lt = bh.launch_tables(tb)

    def launch():
        shipped, bh._kernel = bh._kernel, entry
        try:
            return (bh.human_edges_cuda(*state, lt, act, CAM_BA, HUMAN_SIG,
                                        True, bh.ROWS),)
        finally:
            bh._kernel = shipped
    return launch


def _human_problem(rng, T=8, L=8, C=24):
    """The crowd-27 flagship's human families (8 trajectories x 8 poses:
    896 projection, 896 rigidity and 280 motion edges) on random state,
    tests/test_torch_cuda.py's _human_case: Huber on."""
    import torch
    import airdos_tpu_torch.solvers.human_ba as thba
    N = 14
    dev = "cuda"
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
    exists = rng.random((T, L, N)) > 0.1
    ed = thba.human_edges(
        t(rng.integers(-1, C, (T, L))),
        t(rng.normal(300, 80, (T, L, N, 3)).astype(np.float32)),
        t(rng.random((T, L, N)) > 0.2), t(exists),
        t(rng.random((T, L, N)) > 0.1), t(rng.random(T) > 0.2),
        t(rng.uniform(0.1, 0.3, (T, L)).astype(np.float32)),
        t(rng.random((T, L, 5)) > 0.1), C)
    act = [v.to(torch.float32) for v in (ed.hp_valid, ed.rg_valid,
                                         ed.mo_valid)]
    R = [_rotation(rng) for _ in range(C + T)]
    state = (np.asarray(R[:C]), rng.normal(0, 0.2, (C, 3)),
             rng.uniform([-1, -1, 2], [1, 1, 8], (T, L, N, 3)),
             rng.uniform(0.2, 0.6, (T, N)), np.asarray(R[C:]),
             rng.normal(0, 0.5, (T, 3)))
    state = [t(np.asarray(x, np.float32)) for x in state]
    return state, ed.tables, act


def _rotation(rng):
    from airdos_tpu_torch.geometry.se3 import se3_exp_np
    return se3_exp_np(np.concatenate([np.zeros(3),
                                      rng.normal(0, 0.2, 3)]))[0]


HUMAN_SIG = (0.5, 20.0, 20.0, 2.795483, 1.0, 1.0)


def split_human(problems) -> None:
    """human_edge_blocks: at the first problem's family sizes the stamped
    copy in Gauss-Newton mode; at each problem's the unstamped source's
    device times in its three modes."""
    from airdos_tpu_torch.ops import ba_human as bh
    text = (REPO / "airdos_tpu_torch" / "csrc" / "ba_human.cu").read_text()
    for i, problem in enumerate(problems):
        state, tb, act = problem
        sizes = bh.family_sizes(tb)
        what = f"{sizes[0]} / {sizes[1]} / {sizes[2]} edges"

        def want(mode):
            return _outs(bh.human_edges_ref(*state, tb, act, CAM_BA,
                                            HUMAN_SIG, True, mode))
        if i == 0:
            dll = _build(human_new(text), "ba_human_split")
            run = _human_this_launcher(dll, problem)
            _bits_check(run(), want(bh.ROWS), "human_edge_blocks")
            dll.split_reset()
            ms = _events_ms(run)
            _print_split("human_edge_blocks", what + ", Gauss-Newton mode",
                         ms, _read(dll), HU_PARTS)

        def mode_run(mode, problem=problem):
            state, tb, act = problem
            return lambda: bh.human_edges_cuda(
                *state, tb, act, CAM_BA, HUMAN_SIG, True, mode)
        runs = (("Gauss-Newton", mode_run(bh.ROWS)),
                ("cost mode", mode_run(bh.COST)),
                ("cost sum", mode_run(bh.COST_SUM)))
        for mode, (_, run) in zip((bh.ROWS, bh.COST, bh.COST_SUM), runs):
            _bits_check(_outs(run()), want(mode),
                        f"human_edge_blocks mode {mode}")
        times = [(m, _graph_ms(run)) for m, run in runs]
        print(f"[time] human_edge_blocks {what}: " + "; ".join(
            f"{m} cold {c:.4f} ms (hot {h:.4f})" for m, (c, h) in times),
            flush=True)


SAD_PARTS = ("header loads", "staging", "SAD sums", "finish")


def sad_parent(src: str) -> str:
    """The parent's csrc/stereo_sad.cu (a warp a keypoint): slots 0-3 a
    warp's lane 0 (the header's loads and the window origins, the staging
    loop to __syncwarp, the 11 SADs with their shuffle trees, the first
    minimum, parabola, tests and stores)."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  if (i >= n) return;                      // the whole warp leaves\n",
         "  if (i >= n) return;                      // the whole warp leaves\n"
         "  const long long t0 = clock64();\n"),
        ("  for (int j = lane; j < kWin * kStrip; j += 32) {\n",
         "  const long long t1 = clock64();\n"
         "  for (int j = lane; j < kWin * kStrip; j += 32) {\n"),
        ("  __syncwarp();\n",
         "  __syncwarp();\n  const long long t2 = clock64();\n"),
        ("  int kb = 0;\n", "  const long long t3 = clock64();\n  int kb = 0;\n"),
        ("    accept[i] = ok ? 1 : 0;\n  }\n}\n",
         "    accept[i] = ok ? 1 : 0;\n  }\n  const long long t4 = clock64();\n"
         + _warp_sums("lane == 0", ["t0", "t1", "t2", "t3", "t4"]) + "}\n"),
    ])


def sad_new(src: str) -> str:
    """This csrc/stereo_sad.cu (half a warp a keypoint): slots 0-3 a
    keypoint's lane 0 (the header's loads, every level's scale and width
    and the window rows; the right keypoint's u, the patch and the strip
    staged to __syncwarp; SAD k on lane k; the shuffles, first minimum,
    parabola, tests and stores)."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  const int ik = live ? i : n - 1;         // a spare half works, "
         "writes nothing\n",
         "  const int ik = live ? i : n - 1;         // a spare half works, "
         "writes nothing\n  const long long t0 = clock64();\n"),
        ("  // (2) the right keypoint's u and the patch's column `lane`\n",
         "  const long long t1 = clock64();\n"
         "  // (2) the right keypoint's u and the patch's column `lane`\n"),
        ("  __syncwarp();\n", "  __syncwarp();\n  const long long t2 = clock64();\n"),
        ("  const float sad = __double2float_rn(__dadd_rn(acc[0], acc[1]));\n",
         "  const float sad = __double2float_rn(__dadd_rn(acc[0], acc[1]));\n"
         "  const long long t3 = clock64();\n"),
        ("  accept[i] = ok ? 1 : 0;\n}\n",
         "  accept[i] = ok ? 1 : 0;\n  const long long t4 = clock64();\n"
         + _warp_sums("true", ["t0", "t1", "t2", "t3", "t4"]) + "}\n"),
    ])


def _sad_problem(rng, h=360, w=640, n_levels=8, n=1536):
    """The stereo refinement's inputs at the bench budget: an 8-bit
    texture and its copy shifted 7 px, 8 levels, 1536 keypoints anywhere
    on their levels (tests/test_torch_cuda.py's "random" case): every
    pixel 0 or >= 1, so the kernel is bit-equal to the plain version."""
    import torch
    from airdos_tpu_torch.ops import pyramid as pk
    img = _texture(rng, h, w + 7)
    pl = pk.build_pyramid(torch.from_numpy(img[:, 7:].copy()).cuda(), None,
                          n_levels, 1.2)
    pr = pk.build_pyramid(torch.from_numpy(img[:, :-7].copy()).cuda(), None,
                          n_levels, 1.2)
    oct_l = rng.integers(0, n_levels, n)
    xy_l = np.stack([rng.uniform(-3, w + 3, n), rng.uniform(-3, h + 3, n)],
                    axis=1).astype(np.float32)
    xy_r = (xy_l - [[7.0 + rng.uniform(-1, 1), 0.0]]).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa
    widths = t(np.array([im.shape[1] for im in pl.images], np.int64))
    scales = t(np.array([1.2 ** lvl for lvl in range(n_levels)], np.float32))
    return (t(xy_l), t(oct_l.astype(np.int64)), t(rng.uniform(size=n) < 0.9),
            t(xy_r), t(np.where(rng.uniform(size=n) < 0.8, np.arange(n),
                                rng.integers(0, n, n)).astype(np.int64)),
            t(rng.uniform(size=n) < 0.7), pl.images, pr.images, widths,
            scales, float(np.float32(250.0) / np.float32(0.5)))


def split_sad(parent, cases) -> None:
    """stereo_sad: at the first case's shape (1536 keypoints, 8 levels from
    360x640) the stamped copies (the parent's when given, then this
    one's) through the module's wrapper; at each case's shape each
    unstamped source's device time."""
    import torch
    from airdos_tpu_torch.ops import stereo_sad as ss
    for label, text in _sources(parent, "stereo_sad.cu"):
        tag = "parent" if label else "this"
        name = "stereo_sad" + label
        builds = [(sad_parent if label else sad_new)(text), text]
        for stamped, src in zip((True, False), builds):
            dll = _build(src, f"stereo_sad_{tag}"
                         + ("_split" if stamped else ""))
            entry = _entry(dll, "airdos_stereo_sad",
                           ss._SIGNATURES["airdos_stereo_sad"])
            shipped, ss._kernel = ss._kernel, entry
            try:
                for args in cases[:1] if stamped else cases:
                    want = ss.stereo_sad_ref(*args)
                    got = ss.stereo_sad_cuda(*args)
                    torch.cuda.synchronize()
                    what = (f"{args[0].shape[0]} keypoints, {len(args[6])} "
                            f"levels from {tuple(args[6][0].shape)}")
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise SystemExit(f"{name} {what}: not bit-equal to "
                                         f"the plain version")
                    run = (lambda args=args: ss.stereo_sad_cuda(*args))
                    if stamped:
                        dll.split_reset()
                        ms = _events_ms(run)
                        _print_split(name, what, ms, _read(dll), SAD_PARTS)
                    else:
                        c, h = _graph_ms(run)
                        print(f"[time] stereo_sad ({tag}) {what}: cold "
                              f"{c:.4f} ms (hot {h:.4f})", flush=True)
            finally:
                ss._kernel = shipped


# ------------------------------------------------------- patch_disparity

DISP_PARENT_PARTS = ("staging rounds and barrier", "SAD chains and barrier",
                     "serial minimum, parabola and store")
DISP_PARTS = ("loads, stores and barrier", "SAD sums, shuffle and barrier",
              "shuffle minimum, parabola and store")


def disp_parent(src: str) -> str:
    """The parent's csrc/disparity.cu (a block of 64 threads a probe):
    slots 0-2 a probe's thread 0 (the staging loop to the barrier, the
    SADs, a thread's chain each, to the barrier, the serial first minimum,
    parabola and store)."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  const int half = block / 2;\n",
         "  const long long t0 = clock64();\n  const int half = block / 2;\n"),
        ("  __syncthreads();\n\n  if (t < num_disp) {\n",
         "  __syncthreads();\n  const long long t1 = clock64();\n\n"
         "  if (t < num_disp) {\n"),
        ("  __syncthreads();\n\n  if (t == 0) {\n",
         "  __syncthreads();\n  const long long t2 = clock64();\n\n"
         "  if (t == 0) {\n"),
        ("                   : -1.0f;\n  }\n}\n",
         "                   : -1.0f;\n    const long long t3 = clock64();\n"
         + _warp_sums("true", ["t0", "t1", "t2", "t3"]) + "  }\n}\n"),
    ])


def disp_new(src: str) -> str:
    """This csrc/disparity.cu (four warps a probe): slots 0-2 a probe's
    thread 0 (every row's load, the shared stores and the barrier; the
    SADs' float64 sums, the pair's shuffle and the barrier; warp 0's
    shuffle minimum, the neighbours' shuffles, the parabola and store)."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  const int half = block / 2;\n",
         "  const long long t0 = clock64();\n  const int half = block / 2;\n"),
        ("  const bool int_sums = __syncthreads_and(ints);\n",
         "  const bool int_sums = __syncthreads_and(ints);\n"
         "  const long long t1 = clock64();\n"),
        ("  __syncthreads();\n  if (t >= 32) return;\n",
         "  __syncthreads();\n  const long long t2 = clock64();\n"
         "  if (t >= 32) return;\n"),
        ("                 : -1.0f;\n}\n",
         "                 : -1.0f;\n  const long long t3 = clock64();\n"
         + _warp_sums("true", ["t0", "t1", "t2", "t3"]) + "}\n"),
    ])


def _disp_problem(rng, h=360, w=640, n=40, fractions=False):
    """The torso probes' inputs: an 8-bit texture and its copy 13 px to
    the left (a disparity of 13), n probes anywhere on the image
    (tests/test_torch_cuda.py's case), so the kernel is bit-equal to the
    plain version; with fractions, the texture's pixels + 1 each scaled
    by a factor in [1, 1.5) (not integers, all >= 1: still bit-equal)."""
    import torch
    img = _texture(rng, h, w + 60)
    if fractions:
        img = (img + 1.0) * rng.uniform(1.0, 1.5, img.shape).astype(
            np.float32)
    px = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)],
                  axis=1).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa
    return t(img[:, :w]), t(img[:, 13:13 + w]), t(px)


def split_disp(parent, cases) -> None:
    """patch_disparity: on the first two cases (40 probes at 360x640 on
    8-bit images, then on fractions) the stamped copies (the parent's when
    given, then this one's) through the module's wrapper; on every case
    each unstamped source's device time."""
    import torch
    from airdos_tpu_torch.ops import disparity as dk
    for label, text in _sources(parent, "disparity.cu"):
        tag = "parent" if label else "this"
        name = "patch_disparity" + label
        builds = [(disp_parent if label else disp_new)(text), text]
        for stamped, src in zip((True, False), builds):
            dll = _build(src, f"disparity_{tag}"
                         + ("_split" if stamped else ""))
            entry = _entry(dll, "airdos_patch_disparity",
                           dk._SIGNATURES["airdos_patch_disparity"])
            shipped, dk._kernel = dk._kernel, entry
            try:
                for kind, args in cases[:2] if stamped else cases:
                    want = dk.patch_disparity_ref(*args)
                    got = dk.patch_disparity_cuda(*args)
                    torch.cuda.synchronize()
                    what = (f"{args[2].shape[0]} probes at "
                            f"{args[0].shape[0]}x{args[0].shape[1]}, {kind}")
                    if not torch.equal(got, want):
                        raise SystemExit(f"{name} {what}: not bit-equal to "
                                         f"the plain version")
                    run = (lambda args=args: dk.patch_disparity_cuda(*args))
                    if stamped:
                        dll.split_reset()
                        ms = _events_ms(run)
                        _print_split(name, what, ms, _read(dll),
                                     DISP_PARENT_PARTS if label
                                     else DISP_PARTS)
                    else:
                        c, h = _graph_ms(run)
                        print(f"[time] patch_disparity ({tag}) {what}: cold "
                              f"{c:.4f} ms (hot {h:.4f})", flush=True)
            finally:
                dk._kernel = shipped


# ------------------------------------------------ schur_point, schur_camera

def _slot_sums(cond: str, slots) -> str:
    """`if (cond) { g_split[k] += slots[k] ...; count }`: totals kept in
    the kernel's own variables."""
    adds = "".join(f"    atomicAdd(&g_split[{k}], static_cast<unsigned long "
                   f"long>({v}));\n" for k, v in enumerate(slots))
    return (f"  if ({cond}) {{\n{adds}    atomicAdd(&g_split[7], 1ull);\n"
            f"  }}\n")


SC_PARENT_PARTS = ("loads and rows' y", "the six threads' chain",
                   "Ap, q and the counter", "the last block's update")
SC_PARTS = ("walk loads", "rows' y", "the six lanes' chain, Ap and q",
            "grid barriers", "p.Ap's fixed sum", "x, r, z and r.z",
            "r.z's fixed sum and p")
SP_PARENT_PARTS = ("the walk (loads and products)",)
SP_PARTS = ("staging", "gathers and products")


def camera_parent(src: str) -> str:
    """The parent's csrc/ba_global.cu (a block a camera, the update in the last
    block): slots 0-3 a camera's thread 0 (each chunk's loads and rows' y
    to the barrier, the chain of adds to the next barrier, Ap, q and the
    counter, and in the last block the update)."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  const int begin = a.offsets[c];\n  const int end = a.offsets[c + 1];\n",
         "  long long t_load = 0, t_sum = 0, t_wait = 0, t_upd = 0;\n"
         "  long long t0 = clock64();\n"
         "  const int begin = a.offsets[c];\n  const int end = a.offsets[c + 1];\n"),
        ("    __syncthreads();\n    if (t < 6) {\n",
         "    __syncthreads();\n    const long long t1 = clock64();\n"
         "    t_load += t1 - t0;\n    if (t < 6) {\n"),
        ("    __syncthreads();  // the chunk is read before the next one lands\n  }\n",
         "    __syncthreads();  // the chunk is read before the next one lands\n"
         "    t0 = clock64();\n    t_sum += t0 - t1;\n  }\n"),
        ("  __syncthreads();\n  if (!last) return;\n  __threadfence();\n"
         "  cg_update(a, red);\n}\n",
         "  __syncthreads();\n  t_wait += clock64() - t0;\n  if (last) {\n"
         "    __threadfence();\n    const long long tu = clock64();\n"
         "    cg_update(a, red);\n    t_upd += clock64() - tu;\n  }\n"
         + _slot_sums("t == 0", ["t_load", "t_sum", "t_wait", "t_upd"])
         + "}\n"),
    ])


def camera_new(src: str) -> str:
    """This csrc/ba_global.cu (a warp a camera, the update across the
    cooperative grid): slots 0-6 a warp's lane 0 over its cameras (the
    walk's loads: offsets, the rows and points staged, z gathered, to
    the buffer's barrier; the rows' y; the chain of adds in walk order
    with Ap and q; the wait at the two grid barriers; the update: p.Ap's
    fixed sum with alpha, the cameras' x, r, z and r.z, then r.z's fixed
    sum with beta and p)."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("                                            float back[6]) {\n"
         "  const int begin = a.offsets[c];\n",
         "                                            float back[6], long long& tl,\n"
         "                                            long long& ty, long long& ts) {\n"
         "  long long t0 = clock64();\n  const int begin = a.offsets[c];\n"),
        ("    copies_done();\n    __syncwarp();\n#pragma unroll 4\n",
         "    copies_done();\n    __syncwarp();\n    const long long t1 = clock64();\n"
         "    tl += t1 - t0;\n#pragma unroll 4\n"),
        ("    __syncwarp();\n    if (lane < 6) {       // in walk order",
         "    __syncwarp();\n    const long long t2 = clock64();\n"
         "    ty += t2 - t1;\n    if (lane < 6) {       // in walk order"),
        ("    __syncwarp();   // the buffer is read before the next rows land\n  }\n",
         "    __syncwarp();   // the buffer is read before the next rows land\n"
         "    t0 = clock64();\n    ts += t0 - t2;\n  }\n"),
        ("  for (int k = 0; k < 6; ++k) back[k] = __shfl_sync(kAll, acc, k);\n}\n",
         "  for (int k = 0; k < 6; ++k) back[k] = __shfl_sync(kAll, acc, k);\n"
         "  ts += clock64() - t0;\n}\n"),
        ("  Cam kept;                // the warp's last camera, for the update\n",
         "  Cam kept;                // the warp's last camera, for the update\n"
         "  long long t_load = 0, t_y = 0, t_sum = 0, t_wait = 0, t_fs1 = 0,\n"
         "            t_upd = 0, t_fs2 = 0;\n"),
        ("      camera_sums(a, c, buf, rows, lane, back);\n",
         "      camera_sums(a, c, buf, rows, lane, back, t_load, t_y, t_sum);\n"),
        ("    camera_sums(a, c, buf, rows, lane, back);\n    const float nf",
         "    camera_sums(a, c, buf, rows, lane, back, t_load, t_y, t_sum);\n"
         "    const long long tq = clock64();\n    const float nf"),
        ("    kept.ap = ap;\n  }\n",
         "    kept.ap = ap;\n    t_sum += clock64() - tq;\n  }\n"),
        ("  grid.sync();             // every camera's p.Ap is written\n",
         "  long long tb = clock64();\n"
         "  grid.sync();             // every camera's p.Ap is written\n"
         "  t_wait += clock64() - tb;\n  tb = clock64();\n"),
        ("  const float alpha = fabsf(pap) > kGuard ? __fdiv_rn(rz, pap) : 0.0f;\n",
         "  const float alpha = fabsf(pap) > kGuard ? __fdiv_rn(rz, pap) : 0.0f;\n"
         "  t_fs1 += clock64() - tb;\n  tb = clock64();\n"),
        ("  grid.sync();             // every camera's r.z is written\n",
         "  t_upd += clock64() - tb;\n  tb = clock64();\n"
         "  grid.sync();             // every camera's r.z is written\n"
         "  t_wait += clock64() - tb;\n  tb = clock64();\n"),
        ("  if (blockIdx.x == 0 && threadIdx.x == 0) a.rz[0] = rz_new;\n}\n",
         "  if (blockIdx.x == 0 && threadIdx.x == 0) a.rz[0] = rz_new;\n"
         "  t_fs2 += clock64() - tb;\n"
         + _slot_sums("lane == 0 && first < C",
                      ["t_load", "t_y", "t_sum", "t_wait", "t_fs1", "t_upd",
                       "t_fs2"]) + "}\n"),
    ])


def camera_lanes(src: str) -> str:
    """This csrc/ba_global.cu with schur_camera's sums over lanes: lane j
    adds the y of a camera's rows j, j + 32, ... in float64 from 0, then a
    halving tree over the 32 lanes in float64, rounded to float32 once
    (the buffer's rows a multiple of 32, so that a row keeps its lane)."""
    head = "    if (lane < 6) {       // in walk order"
    tail = "    __syncwarp();   // the buffer is read before the next rows land\n"
    i = src.index(head)
    src = src[:i] + src[src.index(tail, i):]
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  float acc = 0.0f;        // lane k < 6: back[k]\n",
         "  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};\n"),
        ("      for (int m = 0; m < 3; ++m) wi[m] = make_float2(y[2 * m], "
         "y[2 * m + 1]);\n",
         "      for (int k = 0; k < 6; ++k)\n"
         "        acc[k] = __dadd_rn(acc[k], static_cast<double>(y[k]));\n"),
        ("  for (int k = 0; k < 6; ++k) back[k] = __shfl_sync(kAll, acc, k);\n",
         "  for (int off = 16; off > 0; off >>= 1) {\n"
         "#pragma unroll\n"
         "    for (int k = 0; k < 6; ++k)\n"
         "      acc[k] = __dadd_rn(acc[k], __shfl_down_sync(kAll, acc[k], off));\n"
         "  }\n"
         "#pragma unroll\n"
         "  for (int k = 0; k < 6; ++k)\n"
         "    back[k] = __double2float_rn(__shfl_sync(kAll, acc[k], 0));\n"),
        ("  const int rows = ((share - 4) / kCamRowFloats) & ~3;\n",
         "  const int rows = ((share - 4) / kCamRowFloats) & ~31;\n"),
    ])


def camera_sums_lanes_ref(w_c, walk_c, z, wide=True):
    """camera_lanes' sums [C, 6] in torch: a camera's row at position i
    goes to lane i % 32; a lane adds its rows' y in sequence from 0 in
    float64 (wide=False: in y's dtype), then a halving tree over the
    lanes, rounded once."""
    import torch
    zg = z[walk_c.other.long()]
    W = w_c.reshape(-1, 6, 3)
    y = W[:, :, 0] * zg[:, 0:1]
    for m in range(1, 3):
        y = y + W[:, :, m] * zg[:, m:m + 1]
    n, E, dtype = walk_c.n, y.shape[0], y.dtype
    key = walk_c.key
    mine = key < n
    key, y = key[mine], y[mine].double() if wide else y[mine]
    pos = torch.arange(E, device=y.device)[mine] - walk_c.offsets.long()[key]
    slot, rnd = key * 32 + pos % 32, pos // 32
    acc = y.new_zeros(n * 32, 6)
    for k in range(int(rnd.max()) + 1 if rnd.numel() else 0):
        at = rnd == k                  # each (camera, lane) once a round
        acc[slot[at]] = acc[slot[at]] + y[at]
    acc = acc.reshape(n, 32, 6)
    for off in (16, 8, 4, 2, 1):
        acc = acc[:, :off] + acc[:, off:2 * off]
    return acc[:, 0].to(dtype)


def point_parent(src: str) -> str:
    """The parent's schur_point (a thread a point, scalar row loads): slot 0 a
    warp's lane 0 in its point's walk (the loads and products
    interleaved)."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;\n  const int end = offsets[p + 1];\n",
         "  const long long t0 = clock64();\n"
         "  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;\n  const int end = offsets[p + 1];\n"),
        ("  float* o = out + static_cast<int64_t>(p) * 3;\n",
         "  const long long t1 = clock64();\n"
         + _warp_sums("(threadIdx.x & 31) == 0", ["t0", "t1"])
         + "  float* o = out + static_cast<int64_t>(p) * 3;\n"),
    ])


def point_new(src: str) -> str:
    """This schur_point (the block's span staged): slots 0-1 a warp's lane
    0 (the staging's copies to the block barrier, each chunk; the rows'
    gathers and products to the next barrier)."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;\n  for (int s = span0;",
         "  long long t_stage = 0, t_rows = 0;\n  long long t0 = clock64();\n"
         "  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;\n  for (int s = span0;"),
        ("    copies_done();\n    __syncthreads();\n    const int i1",
         "    copies_done();\n    __syncthreads();\n"
         "    const long long t1 = clock64();\n    t_stage += t1 - t0;\n"
         "    const int i1"),
        ("    __syncthreads();  // the buffers are read before the next rows land\n  }\n",
         "    __syncthreads();  // the buffers are read before the next rows land\n"
         "    t0 = clock64();\n    t_rows += t0 - t1;\n  }\n"
         + _slot_sums("(threadIdx.x & 31) == 0", ["t_stage", "t_rows"])),
    ])


SCHUR_SHAPES = (("map scale", 1000, 100_000, 298_380),
                ("pillar", 64, 8192, 45_000),
                ("online", 32, 4096, 16_384),
                ("a mesh rank", 1000, 100_000, 74_595),
                ("the dry run's rank", 4, 32, 64))


def _schur_problem(rng, C, P, E):
    """A seeded reduced camera system at a path's size (tests/
    test_torch_cuda.py's: random edges, a tenth of them and 5% of the
    points outside the walks, camera 0 fixed): the walks' rows of Wcp,
    Hpp^-1, Hcc_d, D^-1, cam_free and b_red on the card."""
    import torch
    from airdos_tpu_torch.ops import ba_global as bg
    from airdos_tpu_torch.ops.segment_kernels import make_segments
    e_cam, e_pt = rng.integers(0, C, E), rng.integers(0, P, E)
    pv = rng.random(P) > 0.05
    base = (rng.random(E) > 0.1) & pv[e_pt]
    A = rng.standard_normal((P, 3, 3)) * 0.05
    hinv = (A @ A.transpose(0, 2, 1) + 0.02 * np.eye(3)) * pv[:, None, None]
    B = rng.standard_normal((C, 6, 6))
    hcc = B @ B.transpose(0, 2, 1) + 400.0 * np.eye(6)
    cf = np.ones(C)
    cf[0] = 0.0
    dinv = np.linalg.inv(hcc)
    dinv[0] = np.eye(6)
    t = lambda a, dt=torch.float32: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to("cuda", dt)
    ec, ep = t(e_cam, torch.int64), t(e_pt, torch.int64)
    keep = t(base, torch.bool)
    wc = bg.make_walk(make_segments(ec, C, keep), ep)
    wp = bg.make_walk(make_segments(ep, P, keep), ec)
    W = t(rng.standard_normal((E, 6, 3)))
    return dict(w_p=bg.walk_rows(W, wp), w_c=bg.walk_rows(W, wc), wp=wp,
                wc=wc, hinv=t(hinv), hcc=t(hcc), dinv=t(dinv), cf=t(cf),
                b=t(rng.standard_normal((C, 6)) * cf[:, None]))


def _schur_launchers(dll, prob, parent: bool):
    """point() and camera(state) through a build's C entry points (the
    parent's point takes no row count, its camera a counter where this
    one takes its grid)."""
    import torch
    from airdos_tpu_torch.ops import ba_global as bg
    sig = bg._SIGNATURES
    pt = _entry(dll, "airdos_schur_point", [ctypes.c_void_p] * 6
                + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 if parent
                else sig["airdos_schur_point"])
    cam_sig = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 2
               + [ctypes.c_void_p] * 2) if parent \
        else sig["airdos_schur_camera"]
    cam = _entry(dll, "airdos_schur_camera", cam_sig)
    C, P = prob["wc"].n, prob["wp"].n
    grid = 0
    if not parent:
        res = _entry(dll, "airdos_schur_residency",
                     sig["airdos_schur_residency"])
        out = (ctypes.c_int * 3)()
        if res(out):
            raise SystemExit("schur_camera residency query failed")
        grid = min(C, out[1] * out[2])
    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    z = torch.empty((P, 3), device="cuda")
    stream = (lambda: torch.cuda.current_stream().cuda_stream)
    x0 = bg.cg_start(prob["b"], prob["dinv"]).p

    sizes = (P,) if parent else (P, prob["w_p"].shape[0])   # this: and E

    def point(raw=0):
        err = pt(prob["w_p"].data_ptr(), prob["wp"].other.data_ptr(),
                 prob["wp"].offsets.data_ptr(), x0.data_ptr(),
                 prob["cf"].data_ptr(), prob["hinv"].data_ptr(), *sizes, raw,
                 z.data_ptr(), stream())
        if err:
            raise SystemExit(f"schur_point: cudaError {err}")
        return z

    def camera(st, raw=0):
        part = st.part[0] if parent else st.part    # the parent's: [C]
        last = (raw, count.data_ptr(), stream()) if parent \
            else (prob["w_c"].shape[0], raw, grid, stream())
        err = cam(prob["w_c"].data_ptr(), prob["wc"].other.data_ptr(),
                  prob["wc"].offsets.data_ptr(), z.data_ptr(),
                  prob["hcc"].data_ptr(), prob["dinv"].data_ptr(),
                  prob["cf"].data_ptr(), st.x.data_ptr(), st.r.data_ptr(),
                  st.p.data_ptr(), st.rz.data_ptr(), st.ap.data_ptr(),
                  part.data_ptr(), C, *last)
        if err:
            raise SystemExit(f"schur_camera: cudaError {err}")
        return st
    return point, camera, x0


def _schur_wants(prob, x0, z):
    """The plain versions' z and CG state after one iteration from
    cg_start, on CPU copies (their segment sums are index_add_ in walk
    order there, atomics on the card), on the card."""
    from airdos_tpu_torch.ops import ba_global as bg

    def cpu(x):
        if isinstance(x, tuple):
            return type(x)(*(cpu(y) for y in x))
        return x.cpu() if hasattr(x, "cpu") else x
    p = {k: cpu(v) for k, v in prob.items()}
    zc = bg.schur_point_ref(p["w_p"], p["wp"], x0.cpu(), p["cf"], p["hinv"])
    st = bg.cg_start(p["b"], p["dinv"])
    bg.schur_camera_ref(p["w_c"], p["wc"], z.cpu(), st, p["hcc"], p["dinv"],
                        p["cf"])
    return zc.cuda(), bg.CGState(*(t.cuda() for t in st))


def _time_lanes(text: str, problems) -> None:
    """camera_lanes' device times (raw and not) at each size, each launch
    first held bit-equal to camera_sums_lanes_ref and the update after it
    to schur_camera_ref's on those sums."""
    from airdos_tpu_torch.ops import ba_global as bg
    dll = _build(camera_lanes(text), "ba_global_lanes")
    shipped = bg.camera_sums_ref
    for size, prob in problems:
        point, camera, x0 = _schur_launchers(dll, prob, False)
        z = point()
        st = camera(bg.cg_start(prob["b"], prob["dinv"]))
        bg.camera_sums_ref = camera_sums_lanes_ref
        try:
            zc, want = _schur_wants(prob, x0, z)
        finally:
            bg.camera_sums_ref = shipped
        _bits_check((z,) + tuple(st[:4]), (zc,) + tuple(want[:4]),
                    "schur_camera (lanes, float64)")
        cc, ch = _graph_ms(lambda: camera(st))
        rcc, rch = _graph_ms(lambda: camera(st, 1))
        print(f"[time] schur (lanes, float64) {size}: C {prob['wc'].n} "
              f"E {prob['w_c'].shape[0]}: schur_camera cold {cc:.4f} ms "
              f"(hot {ch:.4f}); raw cold {rcc:.4f} ms (hot {rch:.4f})",
              flush=True)


def split_schur(parent, problems) -> None:
    """schur_point and schur_camera at the map scale's, pillar's, the
    online pillar's, a map-scale mesh rank's and the dry run's rank's
    sizes: the stamped copies (the parent's when given,
    then this one's), each checked after one CG iteration against its
    plain version (the sums in walk order in both), then the
    unstamped sources' device times (chip_smoke's CUDA graph, cold and
    hot) at each size, also in raw mode."""
    from airdos_tpu_torch.ops import ba_global as bg
    srcs = _sources(parent, "ba_global.cu")
    for label, text in srcs:
        if not label:
            _time_lanes(text, problems)
        old = bool(label)
        tag = "parent" if old else "this"
        builds = [(camera_parent if old else camera_new)(text),
                  (point_parent if old else point_new)(text), text]
        dlls = [_build(b, f"ba_global_{tag}_{i}")
                for i, b in enumerate(builds)]
        for size, prob in problems:
            what = (f"{size}: C {prob['wc'].n} P {prob['wp'].n} E "
                    f"{prob['w_c'].shape[0]} ({int(prob['wc'].offsets[-1])} "
                    f"walked)")
            for i, dll in enumerate(dlls):
                point, camera, x0 = _schur_launchers(dll, prob, old)
                z = point()
                st = camera(bg.cg_start(prob["b"], prob["dinv"]))
                zc, want = _schur_wants(prob, x0, z)
                _bits_check((z,) + tuple(st[:4]), (zc,) + tuple(want[:4]),
                            "schur halves" + label)
                if i < 2:                      # a stamped copy
                    dll.split_reset()
                    run = (lambda: camera(st)) if i == 0 else point
                    ms = _events_ms(run)
                    name = ("schur_camera" if i == 0 else "schur_point") \
                        + label
                    parts = [[SC_PARTS, SC_PARENT_PARTS],
                             [SP_PARTS, SP_PARENT_PARTS]][i][old]
                    _print_split(name, what, ms, _read(dll), parts)
                    continue
                pc, ph = _graph_ms(point)
                cc, ch = _graph_ms(lambda: camera(st))
                rpc, rph = _graph_ms(lambda: point(1))
                rcc, rch = _graph_ms(lambda: camera(st, 1))
                point()                      # z again, for the next launches
                print(f"[time] schur ({tag}) {what}: schur_point cold "
                      f"{pc:.4f} ms (hot {ph:.4f}), schur_camera cold "
                      f"{cc:.4f} ms (hot {ch:.4f}); raw: schur_point cold "
                      f"{rpc:.4f} ms (hot {rph:.4f}), schur_camera cold "
                      f"{rcc:.4f} ms (hot {rch:.4f})", flush=True)


# ----------------------------------------------------- voc_transform, epnp

VOC_BUDGETS_KB = (0, 8, 16, 32, 48)   # shared budgets timed
VOC_PARTS = ("the staging trip (and the descriptor's loads)",
             "the walk and the stores")
VOC_PARENT_PARTS = ("the descriptor's loads", "the walk and the stores")


def voc_new(src: str) -> str:
    """This csrc/voc_transform.cu: slots 0-1 a warp's lane 0 (the staging's
    copies with the descriptor's loads, to the block barrier; the walk
    and the stores)."""
    return _insert(src, [
        ("namespace {\n\nconstexpr int kThreads", WARP_HEAD + "\nconstexpr int kThreads"),
        ("  const int k = static_cast<int>(q.k);\n  const long long S = q.staged;\n",
         "  const long long t0 = clock64();\n"
         "  const int k = static_cast<int>(q.k);\n  const long long S = q.staged;\n"),
        ("  stage_wait();\n  __syncthreads();\n",
         "  stage_wait();\n  __syncthreads();\n  const long long t1 = clock64();\n"),
        ("    q.groups[i] = cur < S ? sgroup[cur] : q.group_of[cur];\n  }\n}\n",
         "    q.groups[i] = cur < S ? sgroup[cur] : q.group_of[cur];\n  }\n"
         "  const long long t2 = clock64();\n"
         + _warp_sums("(threadIdx.x & 31) == 0", ["t0", "t1", "t2"]) + "}\n"),
    ])


def voc_parent(src: str) -> str:
    """The parent's csrc/voc_transform.cu (a thread a descriptor): slots
    0-1 a warp's lane 0 (the descriptor's loads; the walk and the
    stores)."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  if (i >= q.n) return;\n  unsigned d[8];\n",
         "  if (i >= q.n) return;\n  const long long t0 = clock64();\n"
         "  unsigned d[8];\n"),
        ("  const int k = static_cast<int>(q.k);\n  long long cur = 0;\n",
         "  const int k = static_cast<int>(q.k);\n  long long cur = 0;\n"
         "  const long long t1 = clock64();\n"),
        ("  q.groups[i] = q.group_of[cur];\n}\n",
         "  q.groups[i] = q.group_of[cur];\n  const long long t2 = clock64();\n"
         + _warp_sums("(threadIdx.x & 31) == 0", ["t0", "t1", "t2"]) + "}\n"),
    ])


def _voc_problems():
    """[(label, (children, node_desc, word_id, group_of, desc, depth))] on
    the card: a scene vocabulary as System trains it (k 8, depth 3, from
    2,400 descriptors clustered around 40 centres) at N 1536 and 640
    query descriptors, and chip_smoke's random k 10 / depth 6 tree (ORBvoc's
    shape) at N 1536."""
    import torch
    from airdos_tpu_torch.bow.vocabulary import train_vocabulary
    from chip_smoke import _vt_variants
    rng = np.random.default_rng(21)
    centres = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    flip = lambda n, p: np.packbits(rng.random((n, 32, 8)) < p,  # noqa: E731
                                    axis=-1)[..., 0]
    train = centres[rng.integers(0, 40, 2400)] ^ flip(2400, 0.08)
    voc = train_vocabulary(train, k=8, depth=3, device="cuda")
    out = []
    for n in (1536, 640):
        query = centres[rng.integers(0, 40, n)] ^ flip(n, 0.1)
        d = torch.from_numpy(np.ascontiguousarray(query).view(np.int32)
                             .reshape(n, 8)).cuda()
        out.append((f"scene tree of {len(voc.word_id)} nodes (k 8, depth 3), "
                    f"N {n}", (*voc._device_tables(), d, 3)))
    for key, args in _vt_variants([(1536,)]).items():
        out.append((f"random tree of {key[1]} nodes (k 10, depth 6), "
                    f"N {key[0]}", args))
    return out


def split_voc(parent, problems) -> None:
    """voc_transform on the scene trees and the random k 10 / depth 6
    tree: the stamped copies (the parent's when given, then this one's),
    each held bit-equal to voc_transform_ref, then the unstamped sources'
    device times (cold and hot), this one's also with nothing staged."""
    import torch
    from airdos_tpu_torch.ops import voc_kernels as vk
    for label, text in _sources(parent, "voc_transform.cu"):
        old = bool(label)
        tag = "parent" if old else "this"
        _ptxas(text, f"voc_transform_{tag}")
        dlls = [_build((voc_parent if old else voc_new)(text),
                       f"voc_{tag}_split"), _build(text, f"voc_{tag}")]
        for what, args in problems:
            children, node_desc, word_id, group_of, desc, depth = args
            nodes, k = children.shape
            want = vk.voc_transform_ref(*args)
            for i, dll in enumerate(dlls):
                fn = _entry(dll, "airdos_voc_transform",
                            [ctypes.c_void_p, ctypes.c_void_p])
                out = torch.empty((2, desc.shape[0]), dtype=torch.int32,
                                  device="cuda")

                def launch(staged=None):
                    counts = (desc.shape[0], k, depth) + (
                        () if old else (vk.staged_nodes(nodes, k)
                                        if staged is None else staged,))
                    block = ctypes.create_string_buffer(struct.pack(
                        f"<{len(counts) + 7}q", *counts,
                        *(t.data_ptr() for t in (children, node_desc,
                                                 word_id, group_of, desc)),
                        out.data_ptr(), out.data_ptr() + 4 * desc.shape[0]))
                    err = fn(ctypes.addressof(block),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise SystemExit(f"voc_transform: cudaError {err}")
                    return out
                launch()
                torch.cuda.synchronize()
                if not (torch.equal(out[0], want[0])
                        and torch.equal(out[1], want[1])):
                    raise SystemExit(f"voc_transform{label}: not bit-equal "
                                     f"to the plain version ({what})")
                if i == 0:
                    dll.split_reset()
                    ms = _events_ms(launch)
                    _print_split("voc_transform" + label, what, ms,
                                 _read(dll), VOC_PARENT_PARTS if old
                                 else VOC_PARTS)
                    continue
                cold, hot = _graph_ms(launch)
                extra = ""
                if not old:
                    launch(0)
                    torch.cuda.synchronize()
                    if not torch.equal(out[0], want[0]):
                        raise SystemExit("voc_transform with nothing "
                                         "staged: not bit-equal")
                    staged = vk.staged_nodes(nodes, k)
                    extra = (f"; {staged} nodes staged "
                             f"({vk.stage_bytes(staged, k)} bytes a block)")
                    for kb in VOC_BUDGETS_KB:   # the budget's choice
                        sb = min(nodes, kb * 1024 // (4 * k + 40))
                        while vk.stage_bytes(sb, k) > kb * 1024:
                            sb -= 1
                        cb, hb = _graph_ms(lambda: launch(sb))
                        extra += (f"; {kb} KB ({sb} nodes): cold {cb:.4f} "
                                  f"ms (hot {hb:.4f})")
                print(f"[time] voc_transform ({tag}) {what}: cold "
                      f"{cold:.4f} ms (hot {hot:.4f}){extra}", flush=True)


EP_PARTS = ("the sums", "the 12 x 12 solve", "the canonical basis, G and rho",
            "the candidates and their errors", "the inlier test and stores")
EP_PARENT_PARTS = ("the sums", "the 12 x 12 Jacobi",
                   "the canonical basis, G, rho and the candidates",
                   "the errors", "the inlier test and stores")


def epnp_new(src: str) -> str:
    """This csrc/ransac.cu's epnp_kernel (a warp a hypothesis): slots 0-4
    a warp's lane 0 (the sums to M^T M; the 12 x 12 solve; the canonical
    basis, G and rho; the candidates and their errors with the pose;
    the inlier test and the stores), 5 the 12 x 12 solve's sweeps, 6
    the warps, 7 the warps that solved."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  const int mi = static_cast<int>(q.refine ? 0 : m);\n",
         "  const int mi = static_cast<int>(q.refine ? 0 : m);\n"
         "  const long long t0 = clock64();\n"),
        ("  // M^T M from the 10 pairs j <= k of 4 sums each",
         "  const long long t1 = clock64();\n"
         "  // M^T M from the 10 pairs j <= k of 4 sums each"),
        ("  small::warp_jacobi_eigh<12>(s.A, s.V, s.w, s.rot, lane);\n",
         "  const int sweeps = small::warp_jacobi_eigh<12>(s.A, s.V, s.w, s.rot, lane);\n"
         "  const long long t2 = clock64();\n"),
        ("  // the two candidates side by side, a lane each\n",
         "  const long long t3 = clock64();\n"
         "  // the two candidates side by side, a lane each\n"),
        ("    round_pose(s.Rf, s.tf, s.Rc[k], s.tc[k]);\n  }\n  __syncwarp();\n}\n",
         "    round_pose(s.Rf, s.tf, s.Rc[k], s.tc[k]);\n  }\n  __syncwarp();\n"
         "  const long long t4 = clock64();\n"
         "  if (lane == 0) {\n"
         "    atomicAdd(&g_split[0], static_cast<unsigned long long>(t1 - t0));\n"
         "    atomicAdd(&g_split[1], static_cast<unsigned long long>(t2 - t1));\n"
         "    atomicAdd(&g_split[2], static_cast<unsigned long long>(t3 - t2));\n"
         "    atomicAdd(&g_split[3], static_cast<unsigned long long>(t4 - t3));\n"
         "    atomicAdd(&g_split[5], static_cast<unsigned long long>(sweeps));\n"
         "    atomicAdd(&g_split[7], 1ull);\n  }\n}\n"),
        ("  unsigned char* out_inl = q.inliers + h * q.n;\n",
         "  const long long ti = clock64();\n"
         "  unsigned char* out_inl = q.inliers + h * q.n;\n"),
        ("    q.counts[h] = static_cast<long long>(keep ? cnt : cnt_b);\n  }\n}\n\n"
         "__global__ void __launch_bounds__(kThreads) horn_kernel",
         "    q.counts[h] = static_cast<long long>(keep ? cnt : cnt_b);\n  }\n"
         "  if (lane == 0) {\n"
         "    atomicAdd(&g_split[4], static_cast<unsigned long long>(clock64() - ti));\n"
         "    atomicAdd(&g_split[6], 1ull);\n  }\n}\n\n"
         "__global__ void __launch_bounds__(kThreads) horn_kernel"),
    ])


def epnp_parent(src: str) -> str:
    """The parent's epnp_kernel (a block a hypothesis, the dense work on
    thread 0): slots 0-4 a block's thread 0 (the sums to M^T M; the 12 x
    12 Jacobi; the canonical basis, G, rho and the candidates; the
    errors with the pose; the inlier test and the stores), 6 and 7 the
    blocks."""
    return _insert(src, [
        ("namespace {\n", HEAD),
        ("  const int tid = threadIdx.x;\n  // centroid\n",
         "  const int tid = threadIdx.x;\n  const long long t0 = clock64();\n"
         "  // centroid\n"),
        ("  small::jacobi_eigh<12>(d.A, d.V, d.w);\n",
         "  const long long tj = clock64();\n"
         "  small::jacobi_eigh<12>(d.A, d.V, d.w);\n"
         "  s_split[1] = clock64() - tj;\n"),
        ("  if (tid == 0) epnp_candidates(q, sh, d, s, sh.cps, c0);\n",
         "  const long long t1 = clock64();\n"
         "  if (tid == 0) epnp_candidates(q, sh, d, s, sh.cps, c0);\n"
         "  const long long t2 = clock64();\n"),
        ("    round_pose(sh, R, t, 1.0);\n  }\n  __syncthreads();\n}\n",
         "    round_pose(sh, R, t, 1.0);\n  }\n  __syncthreads();\n"
         "  if (tid == 0) {\n"
         "    atomicAdd(&g_split[0], static_cast<unsigned long long>(t1 - t0));\n"
         "    atomicAdd(&g_split[1], static_cast<unsigned long long>(s_split[1]));\n"
         "    atomicAdd(&g_split[2], static_cast<unsigned long long>(t2 - t1 - s_split[1]));\n"
         "    atomicAdd(&g_split[3], static_cast<unsigned long long>(clock64() - t2));\n"
         "    atomicAdd(&g_split[7], 1ull);\n  }\n}\n"),
        ("  unsigned char* out_inl = q.inliers + blockIdx.x * q.n;\n"
         "  double cnt_b = 0.0;\n  const double cnt = epnp_inliers(",
         "  const long long ti = clock64();\n"
         "  unsigned char* out_inl = q.inliers + blockIdx.x * q.n;\n"
         "  double cnt_b = 0.0;\n  const double cnt = epnp_inliers("),
        ("  finish(q, sh, cnt, cnt_b, out_inl);\n}\n\n"
         "__global__ void __launch_bounds__(kThreads) horn_kernel",
         "  finish(q, sh, cnt, cnt_b, out_inl);\n"
         "  if (threadIdx.x == 0) {\n"
         "    atomicAdd(&g_split[4], static_cast<unsigned long long>(clock64() - ti));\n"
         "    atomicAdd(&g_split[6], 1ull);\n  }\n}\n\n"
         "__global__ void __launch_bounds__(kThreads) horn_kernel"),
    ])


def _epnp_problems():
    """[(label, refine, args)]: relocalization's hypotheses (H 256 n 483),
    a mesh rank's (H 64) and the dry run's (H 16 n 48), and the refines
    at n 483 and 48 from each scene's best hypothesis, on the card
    (tests/torch_ransac_cases.py pnp_case, 0.5 px noise, a fifth of the
    points moved 20-60 px)."""
    import torch
    sys.path.insert(0, str(REPO / "tests"))
    import torch_ransac_cases as trc
    from airdos_tpu_torch.solvers import epnp as ep
    cam = (trc.FX, trc.FY, trc.CX, trc.CY)
    out = []
    for seed, n, hs in ((3, 483, (256, 64)), (4, 48, (16,))):
        pw, uv, valid, gate, smp = (torch.from_numpy(np.array(a)).cuda()
                                    for a in trc.pnp_case(
                                        seed, n=n, n_out=n // 5, H=max(hs)))
        for H in hs:
            out.append((f"hypotheses H {H} n {n}", False,
                        (pw, uv, valid, gate, smp[:H].contiguous(), *cam)))
        plain = ep.epnp_hypotheses_ref(pw, uv, valid, gate, smp, *cam,
                                       canonical=True)
        best = int(torch.argmax(plain[3]))
        out.append((f"refine n {n}", True,
                    (pw, uv, valid, gate, plain[0][best].contiguous(),
                     plain[1][best].contiguous(),
                     plain[2][best].contiguous(), *cam)))
    return out


def epnp_variants(text: str, header: str):
    """[(name, source, small_eig.cuh)] variants of this epnp_kernel, timed
    beside it and not shipped: the round-robin solver not inlined; its
    rotation by jacobi_eigh's formulas (three divisions and two square
    roots) in place of a hypot, a division and a reciprocal square root,
    or from two reciprocal square roots (c = sqrt((1 + |h| / r) /
    2), s = sign(h) apq / (r c) by rsqrt of h^2 + 4 apq^2 and of c^2);
    its sweeps and steps kept rolled (no unrolling of the 11 steps of a
    sweep); the kernel held to 128 registers a thread (launch bounds of 4
    blocks an SM)."""
    noinline = ("__device__ int warp_jacobi_eigh(",
                "__device__ __noinline__ int warp_jacobi_eigh(")
    formulas = ("""    const double a2 = apq + apq;
    t = (h < 0.0 ? -a2 : a2) / (fabs(h) + hypot(h, a2));
  }
  c = rsqrt(1.0 + t * t);""", """    const double theta = 0.5 * h / apq;
    t = 1.0 / (fabs(theta) + sqrt(1.0 + theta * theta));
    if (theta < 0.0) t = -t;
  }
  c = 1.0 / sqrt(1.0 + t * t);""")
    two_rsqrt = ("""  const double h = aqq - app;
  double t;
  if (fabs(h) + g == fabs(h)) {
    t = apq / h;
  } else {
    const double a2 = apq + apq;
    t = (h < 0.0 ? -a2 : a2) / (fabs(h) + hypot(h, a2));
  }
  c = rsqrt(1.0 + t * t);
  s = t * c;""", """  const double h = aqq - app;
  const double ir = rsqrt(h * h + 4.0 * apq * apq);
  const double x = 0.5 + 0.5 * fabs(h) * ir;
  const double ic = rsqrt(x);
  c = x * ic;
  s = (h < 0.0 ? -apq : apq) * ir * ic;""")
    rolled = [("    for (int r = 0; r < N - 1; ++r) {   // a step",
               "#pragma unroll 1\n    for (int r = 0; r < N - 1; ++r) {   // a step"),
              ("  for (; sweep < kMaxSweeps; ++sweep) {   // a sweep",
               "#pragma unroll 1\n  for (; sweep < kMaxSweeps; ++sweep) {   // a sweep")]
    bounds = ("__launch_bounds__(kHypsPerBlock * 32) epnp_kernel",
              "__launch_bounds__(kHypsPerBlock * 32, 4) epnp_kernel")

    out = []
    for name, edits, src_edits in (("solver not inlined", [noinline], []),
                                   ("jacobi_eigh's formulas", [formulas], []),
                                   ("two reciprocal square roots",
                                    [two_rsqrt], []),
                                   ("steps not unrolled", rolled, []),
                                   ("128 registers", [], [bounds])):
        h, t = header, text
        for a, b in edits:
            if h.count(a) != 1:
                raise SystemExit(f"epnp variant {name}: anchor not found")
            h = h.replace(a, b)
        for a, b in src_edits:
            if t.count(a) != 1:
                raise SystemExit(f"epnp variant {name}: anchor not found")
            t = t.replace(a, b)
        out.append((name, t, h))
    return out


SOLVE_C = """
extern "C" int solve_read(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_solve, sizeof(g_solve)));
}
"""


def solver_split(header: str) -> str:
    """small_eig.cuh with the 12 x 12 round-robin solve's steps stamped:
    g_solve[0-1] lane 0's cycles in the rotations to the warp barrier and
    in its item (a block of A, a run of V) to the next barrier, [3] the
    steps."""
    edits = [
        ("namespace small {\n",
         "__device__ unsigned long long g_solve[4];\nnamespace small {\n"),
        ("  int sweep = 0;\n  for (; sweep < kMaxSweeps; ++sweep) {   // a sweep\n",
         "  long long solve_t[4] = {0, 0, 0, 0};\n"
         "  int sweep = 0;\n  for (; sweep < kMaxSweeps; ++sweep) {   // a sweep\n"),
        ("    for (int r = 0; r < N - 1; ++r) {   // a step\n",
         "    for (int r = 0; r < N - 1; ++r) {   // a step\n"
         "      const long long ta = clock64();\n"),
        ("        rot[1][P] = s;\n      }\n      __syncwarp();\n",
         "        rot[1][P] = s;\n      }\n      __syncwarp();\n"
         "      const long long tb = clock64();\n"),
        ("      __syncwarp();\n    }\n  }\n  // ascending,",
         "      __syncwarp();\n"
         "      solve_t[0] += tb - ta;\n      solve_t[1] += clock64() - tb;\n"
         "      solve_t[3] += 1;\n"
         "    }\n  }\n"
         "  if (lane == 0 && N == 12)\n"
         "    for (int k = 0; k < 4; ++k)\n"
         "      atomicAdd(&g_solve[k], static_cast<unsigned long long>(solve_t[k]));\n"
         "  // ascending,"),
    ]
    for a, b in edits:
        if header.count(a) != 1:
            raise SystemExit(f"solver_split: anchor not found once: {a!r}")
        header = header.replace(a, b)
    return header


def _time_solver_split(text: str, problems) -> None:
    """The 12 x 12 solve's steps split (solver_split) at each problem."""
    import torch
    from airdos_tpu_torch.ops import ransac_kernels as rk
    header = (REPO / "airdos_tpu_torch" / "csrc" / "small_eig.cuh").read_text()
    dll = _build(epnp_new(text) + SOLVE_C, "ransac_solver_split",
                 headers={"small_eig.cuh": solver_split(header)})
    dll.solve_read.argtypes = [ctypes.c_void_p]
    for what, refine, args in problems:
        shipped = rk._lib
        rk._lib = dll
        for name, argtypes in rk._SIGNATURES.items():
            _entry(dll, name, argtypes)
        try:
            before = (ctypes.c_ulonglong * 4)()
            dll.solve_read(before)
            (rk.epnp_refine_cuda(*args) if refine
             else rk.epnp_hypotheses_cuda(*args))
            torch.cuda.synchronize()
            after = (ctypes.c_ulonglong * 4)()
            dll.solve_read(after)
        finally:
            rk._lib = shipped
        d = [a - b for a, b in zip(after, before)]
        steps = max(d[3], 1)
        print(f"[split] epnp 12 x 12 solve {what}: cycles a step (lane 0, "
              f"{steps} steps over the launch's warps): the rotations to "
              f"the barrier {d[0] / steps:.0f}, its block of A and run of "
              f"V to the barrier {d[1] / steps:.0f}", flush=True)


def split_epnp(parent, problems) -> None:
    """epnp_hypotheses and epnp_refine at the paths' shapes: the stamped
    copies (the parent's when given, then this one's), each held to its
    plain version (ops/ransac_kernels hypotheses_held / refine_held), then
    the unstamped sources' device times (cold and hot)."""
    import torch
    from airdos_tpu_torch.ops import ransac_kernels as rk
    from airdos_tpu_torch.solvers import epnp as ep
    for label, text in _sources(parent, "ransac.cu"):
        old = bool(label)
        tag = "parent" if old else "this"
        inc = parent / "airdos_tpu_torch" / "csrc" if old else None
        _ptxas(text, f"ransac_{tag}", inc)
        dlls = [_build((epnp_parent if old else epnp_new)(text),
                       f"ransac_{tag}_split", inc),
                _build(text, f"ransac_{tag}", inc)]
        for what, refine, args in problems:
            if refine:
                plain = ep.epnp_refine_ref(*args, canonical=True)
                plain64 = ep.epnp_refine_ref(*(
                    a.double() if i in (0, 1, 3, 4, 5) else a
                    for i, a in enumerate(args)), canonical=True)
            else:
                plain = ep.epnp_hypotheses_ref(*args, canonical=True)
                other = ep.epnp_hypotheses_ref(*args, canonical=True,
                                               solve_dtype=torch.float32)
            for i, dll in enumerate(dlls):
                shipped = rk._lib
                rk._lib = dll
                for name, argtypes in rk._SIGNATURES.items():
                    _entry(dll, name, argtypes)
                try:
                    run = (lambda: rk.epnp_refine_cuda(*args)) if refine \
                        else (lambda: rk.epnp_hypotheses_cuda(*args))
                    got = run()
                    torch.cuda.synchronize()
                    held, st = (rk.refine_held(got, plain, plain64) if refine
                                else rk.hypotheses_held(got, plain, other,
                                                        args[4]))
                    if not held:
                        raise SystemExit(f"epnp{label} {what}: not held to "
                                         f"its plain version: {st}")
                    if i == 0:
                        dll.split_reset()
                        ms = _events_ms(run)
                        acc = _read(dll)
                        n = max(acc[7], 1)
                        parts = EP_PARENT_PARTS if old else EP_PARTS
                        per = ", ".join(
                            f"{k} {acc[j] / max(acc[6 if j == 4 else 7], 1):.0f}"
                            for j, k in enumerate(parts))
                        sweeps = "" if old else \
                            f"; sweeps of the 12 x 12 solve {acc[5] / n:.2f}"
                        print(f"[split] epnp{label} {what}: {ms * 1e3:.1f} us "
                              f"a launch (CUDA events, 20 back to back; the "
                              f"stamped copy); cycles a hypothesis ("
                              f"{'thread 0' if old else 'lane 0'}, mean of "
                              f"{n // 21} a launch): {per}{sweeps}; held: "
                              f"{st}", flush=True)
                        continue
                    cold, hot = _graph_ms(run)
                    print(f"[time] epnp ({tag}) {what}: cold {cold:.4f} ms "
                          f"(hot {hot:.4f})", flush=True)
                finally:
                    rk._lib = shipped
        if old:
            continue
        _time_solver_split(text, problems)
        header = (REPO / "airdos_tpu_torch" / "csrc" /
                  "small_eig.cuh").read_text()
        for j, (vname, vtext, vheader) in enumerate(
                epnp_variants(text, header)):
            dll = _build(vtext, f"ransac_variant_{j}",
                         headers={"small_eig.cuh": vheader})
            _ptxas(vtext, f"ransac_variant_{j}",
                   cuda_build_dir() / "split" / f"ransac_variant_{j}")
            for what, refine, args in problems:
                shipped = rk._lib
                rk._lib = dll
                for name, argtypes in rk._SIGNATURES.items():
                    _entry(dll, name, argtypes)
                try:
                    run = (lambda: rk.epnp_refine_cuda(*args)) if refine \
                        else (lambda: rk.epnp_hypotheses_cuda(*args))
                    got = run()
                    again = run()
                    torch.cuda.synchronize()
                    if refine:
                        plain = ep.epnp_refine_ref(*args, canonical=True)
                        plain64 = ep.epnp_refine_ref(*(
                            a.double() if i in (0, 1, 3, 4, 5) else a
                            for i, a in enumerate(args)), canonical=True)
                        held, st = rk.refine_held(got, plain, plain64)
                    else:
                        plain = ep.epnp_hypotheses_ref(*args, canonical=True)
                        other = ep.epnp_hypotheses_ref(
                            *args, canonical=True, solve_dtype=torch.float32)
                        held, st = rk.hypotheses_held(got, plain, other,
                                                      args[4])
                    same = all(torch.equal(a.nan_to_num(7.0),
                                           b.nan_to_num(7.0))
                               if a.is_floating_point() else torch.equal(a, b)
                               for a, b in zip(got, again))
                    cold, hot = _graph_ms(run)
                    print(f"[time] epnp variant ({vname}) {what}: cold "
                          f"{cold:.4f} ms (hot {hot:.4f}); held {held}, two "
                          f"launches equal {same}: {st}", flush=True)
                finally:
                    rk._lib = shipped



SPLITS = ("pose_lm", "select", "orb_desc", "static_edge_blocks", "fast_nms",
          "pyramid", "landmark",
          "human_edge_blocks", "stereo_sad", "patch_disparity", "schur_point",
          "schur_camera", "voc_transform", "epnp")


def main(argv=None) -> None:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an unpacked checkout of the commit before a "
                         "kernel's redesign (landmark, stereo_sad, "
                         "patch_disparity, schur_point / schur_camera)")
    ap.add_argument("--only", nargs="+", choices=SPLITS, default=SPLITS,
                    help="the kernels to split (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_split: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[split] card: {smi}", flush=True)
    csrc = REPO / "airdos_tpu_torch" / "csrc"
    only = set(args.only)
    if "pose_lm" in only:
        split_pose(_build(pose_new((csrc / "pose_lm.cu").read_text()),
                          "pose_lm_split"), "pose_lm")
    fe = _front_end() if only & {"select", "orb_desc", "fast_nms"} else None
    if "select" in only:
        split_select(_build(select_new((csrc / "select.cu").read_text()),
                            "select_split"), "select", fe)
    if "orb_desc" in only:
        split_orb_new(fe)
    if "static_edge_blocks" in only:
        split_static_new(_static_problem(np.random.default_rng(1)))
    if "fast_nms" in only:
        split_fast(fe[0])
    if "pyramid" in only:
        split_pyramid(*_pyramid_inputs())
    if "landmark" in only:
        split_landmark(args.parent,
                       _landmark_problem(np.random.default_rng(1)))
    if "human_edge_blocks" in only:
        rng = np.random.default_rng(1)
        split_human([_human_problem(rng), _human_problem(rng, T=1, L=4, C=8)])
    if "stereo_sad" in only:
        rng = np.random.default_rng(9)
        split_sad(args.parent, [_sad_problem(rng),
                                _sad_problem(rng, 240, 320, 4, 640)])
    if only & {"schur_point", "schur_camera"}:      # split together
        rng = np.random.default_rng(21)
        split_schur(args.parent, [(size, _schur_problem(rng, C, P, E))
                                  for size, C, P, E in SCHUR_SHAPES])
    if "voc_transform" in only:
        split_voc(args.parent, _voc_problems())
    if "epnp" in only:
        split_epnp(args.parent, _epnp_problems())
    if "patch_disparity" in only:
        rng = np.random.default_rng(3)
        split_disp(args.parent, [
            ("8-bit", _disp_problem(rng)),
            ("fractions", _disp_problem(rng, fractions=True)),
            ("8-bit", _disp_problem(rng, 240, 320))])


if __name__ == "__main__":
    os.chdir(REPO)
    main()
