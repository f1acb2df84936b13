"""Where a launch of pose_lm, select, orb_desc or static_edge_blocks
spends its time on the card, from clock64() stamps in an instrumented copy
of the kernel's source.

    python3 tools/kernel_split.py [--parent DIR]

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
  projection, the block barrier, the float64 entries and the stores.

Then the device time (chip_smoke.py's CUDA graph, L2 cold and hot) of the
shipped orb_desc (level 0; the 8 levels) and static_edge_blocks (each
mode).  With --parent DIR (a `git archive` of the commit before the
redesign of orb_desc and static_edge_blocks, unpacked in DIR), also its
orb_desc.cu (a launch a level) and ba_static.cu (a thread an edge) at the
same inputs: the split (disc loads, reduction, transcendentals, sample
rounds; gathers and projection, float64 rows, stores) and the device time
of the unstamped source (level 0 and the 8 launches of the 8 levels;
Gauss-Newton mode, cost mode, and cost mode followed by lm_cost).  Each
copy's result is held against the plain version (pose_lm's R and t within
1e-4; the others bit-equal); the split is printed beside the launch's time
(CUDA events) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# (cold, hot) device ms a call: chip_smoke.py's CUDA graph of 100 calls,
# each after a 64 MB L2-evicting write (cold), and back to back (hot)
from chip_smoke import _graph_ms  # noqa: E402

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


def _build(text: str, name: str, include: Path = None) -> ctypes.CDLL:
    """Build a copy of a source into _build/split/ with the port's nvcc
    command (its headers from `include`, csrc/ by default) and load it."""
    from airdos_tpu_torch.ops import cuda_build
    out_dir = cuda_build.BUILD_DIR / "split"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    lib = out_dir / f"lib{name}.so"
    cmd = [cuda_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", str(include or cuda_build.CSRC), "-o", str(lib), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{res.stderr}")
    dll = ctypes.CDLL(str(lib))
    if hasattr(dll, "split_read"):
        dll.split_read.argtypes = [ctypes.c_void_p]
    return dll


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


def orb_parent(src: str) -> str:
    """PR 9's csrc/orb_desc.cu (a launch a level): slots 0-3 per warp
    (the disc loads, the reduction, the transcendentals, the 8 sample
    rounds), 7 warps."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  if (kp >= n) return;  // the whole warp\n",
         "  if (kp >= n) return;  // the whole warp\n"
         "  const long long t0 = clock64();\n"),
        ("    }\n  }\n#pragma unroll\n  for (int off = 16;",
         "    }\n  }\n  const long long t1 = clock64();\n"
         "#pragma unroll\n  for (int off = 16;"),
        ("  m01 = __shfl_sync(0xffffffffu, m01, 0);\n",
         "  m01 = __shfl_sync(0xffffffffu, m01, 0);\n"
         "  const long long t2 = clock64();\n"),
        ("  const float sa = sinf(r);\n",
         "  const float sa = sinf(r);\n  const long long t3 = clock64();\n"),
        ("static_cast<int32_t>(bits);\n  }\n}\n",
         "static_cast<int32_t>(bits);\n  }\n  const long long t4 = clock64();\n"
         + _warp_sums("lane == 0", ["t0", "t1", "t2", "t3", "t4"]) + "}\n"),
    ])


def static_parent(src: str) -> str:
    """PR 11's csrc/ba_static.cu (a thread an edge), Gauss-Newton mode:
    slots 0-2 per warp's lane 0 (the gathers and projection with the
    weight, the float64 rows into registers, the 72 stores issued), 7
    warps."""
    return _insert(src, [
        ("namespace {\n", WARP_HEAD),
        ("  if (i >= n) return;\n",
         "  if (i >= n) return;\n  const long long t0 = clock64();\n"),
        ("  const float w = mul(huber ? mul(base, factor) : base, active[i]);\n",
         "  const float w = mul(huber ? mul(base, factor) : base, active[i]);\n"
         "  const long long t1 = clock64();\n"),
        ("  float* cam = out0 + 42 * int64_t{i};\n"
         "  float* pt = out1 + 12 * int64_t{i};\n"
         "  float* pc = out2 + 18 * int64_t{i};\n"
         "  ba::normal_rows<3, 6>(pr.Jc, w, pr.e, cam, cam + 36);\n"
         "  ba::normal_rows<3, 3>(pr.Jp, w, pr.e, pt, pt + 9);\n"
         "  ba::weighted_cross<3, 6, 3>(pr.Jc, w, pr.Jp, pc);\n}\n",
         "  float row[72];\n"
         "  ba::normal_rows<3, 6>(pr.Jc, w, pr.e, row, row + 36);\n"
         "  ba::normal_rows<3, 3>(pr.Jp, w, pr.e, row + 42, row + 51);\n"
         "  ba::weighted_cross<3, 6, 3>(pr.Jc, w, pr.Jp, row + 54);\n"
         "  const long long t2 = clock64();\n"
         "  float* cam = out0 + 42 * int64_t{i};\n"
         "  float* pt = out1 + 12 * int64_t{i};\n"
         "  float* pc = out2 + 18 * int64_t{i};\n"
         "#pragma unroll\n  for (int k = 0; k < 42; ++k) cam[k] = row[k];\n"
         "#pragma unroll\n  for (int k = 0; k < 12; ++k) pt[k] = row[42 + k];\n"
         "#pragma unroll\n  for (int k = 0; k < 18; ++k) pc[k] = row[54 + k];\n"
         "  const long long t3 = clock64();\n"
         + _warp_sums("(threadIdx.x & 31) == 0", ["t0", "t1", "t2", "t3"])
         + "}\n"),
    ])


# PR 12's C entry points, which the parent's copies export
PARENT_SIGNATURES = {
    "airdos_orb_desc": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 3,
    "airdos_static_edges": [ctypes.c_void_p] * 8 + [ctypes.c_int]
    + [ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4,
}


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
    maps = [fast.fast_nms(im, m, 7.0, 16)
            for im, m in zip(pyr.images, pyr.masks)]
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


def _orb_parent_launch(entry, pyr, quotas, xs, ys, levels):
    """The parent's per-level launches of `levels`, as PR 12's extractor
    made them (outputs allocated a launch)."""
    import torch
    from airdos_tpu_torch.ops import orb_kernels as ok
    pat = ok.pattern_points("cuda")
    slots = _level_slots(quotas)

    def launch():
        out = []
        for lvl in levels:
            img, blur = pyr.images[lvl], pyr.blurred[lvl]
            x, y = xs[slots[lvl]], ys[slots[lvl]]
            n = x.shape[0]
            ang = torch.empty(n, device="cuda")
            desc = torch.empty((n, 8), dtype=torch.int32, device="cuda")
            err = entry(img.data_ptr(), blur.data_ptr(), x.data_ptr(),
                        y.data_ptr(), pat.data_ptr(), n, img.shape[0],
                        img.shape[1], ang.data_ptr(), desc.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"orb_desc (parent): cudaError {err}")
            out.append((ang, desc))
        return out
    return launch


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


def split_orb_parent(parent: Path, fe) -> None:
    """PR 12's orb_desc: the stamped copy at level 0 (326 keypoints), then
    the unstamped parent's device time at level 0 and over the 8 levels'
    launches."""
    pyr, _, quotas, _, xs, ys = fe
    src = (parent / "airdos_tpu_torch" / "csrc" / "orb_desc.cu").read_text()
    dll = _build(orb_parent(src), "orb_desc_parent_split")
    entry = _entry(dll, "airdos_orb_desc", PARENT_SIGNATURES["airdos_orb_desc"])
    launch = _orb_parent_launch(entry, pyr, quotas, xs, ys, [0])
    _orb_check(launch(), pyr, quotas, xs, ys, [0], "orb_desc (parent)")
    dll.split_reset()
    ms = _events_ms(launch)
    _print_split("orb_desc (parent)", f"level 0 360x640, {quotas[0]} "
                 "keypoints", ms, _read(dll), ORB_PARTS)
    entry = _entry(_build(src, "orb_desc_parent"), "airdos_orb_desc",
                   PARENT_SIGNATURES["airdos_orb_desc"])
    every = list(range(len(quotas)))
    one = _orb_parent_launch(entry, pyr, quotas, xs, ys, [0])
    all_levels = _orb_parent_launch(entry, pyr, quotas, xs, ys, every)
    _orb_check(all_levels(), pyr, quotas, xs, ys, every, "orb_desc (parent)")
    c0, h0 = _graph_ms(one)
    c8, h8 = _graph_ms(all_levels)
    print(f"[time] orb_desc (parent, a launch a level): level 0 cold "
          f"{c0:.4f} ms (hot {h0:.4f}); the 8 levels' 8 launches cold "
          f"{c8:.4f} ms (hot {h8:.4f}), {sum(quotas)} slots", flush=True)


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


def _static_parent_launch(entry, args, cost: bool):
    import torch
    from airdos_tpu_torch.ops.cuda_build import consts
    E = args[3].shape[0]
    dims = (1, 1, 1) if cost else (42, 12, 18)
    k = consts(*CAM_BA, 1.0)

    def launch():
        out = [torch.empty((E, d), device="cuda").squeeze(1) for d in dims]
        err = entry(*(a.data_ptr() for a in args), E, k, 1, int(cost),
                    *(o.data_ptr() for o in out),
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"static_edge_blocks (parent): cudaError {err}")
        return out
    return launch


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


STATIC_PARTS = ("gathers and projection", "float64 rows", "stores")


def split_static_parent(parent: Path, args) -> None:
    """PR 11's static_edge_blocks at E 8192 C 24 P 2048: the stamped copy
    in Gauss-Newton mode, then the unstamped parent's device time in
    Gauss-Newton mode and in cost mode followed by lm_cost (the pair a
    cost made)."""
    from airdos_tpu_torch.ops import lm_cost as lc
    csrc = parent / "airdos_tpu_torch" / "csrc"
    src = (csrc / "ba_static.cu").read_text()
    sig = PARENT_SIGNATURES["airdos_static_edges"]
    dll = _build(static_parent(src), "ba_static_parent_split", csrc)
    launch = _static_parent_launch(_entry(dll, "airdos_static_edges", sig),
                                   args, False)
    _static_check(launch(), args, False, "static_edge_blocks (parent)")
    dll.split_reset()
    ms = _events_ms(launch)
    _print_split("static_edge_blocks (parent)", "E 8192 C 24 P 2048, "
                 "Gauss-Newton mode", ms, _read(dll), STATIC_PARTS)
    plain = _entry(_build(src, "ba_static_parent", csrc),
                   "airdos_static_edges", sig)
    rows = _static_parent_launch(plain, args, False)
    cost = _static_parent_launch(plain, args, True)
    _static_check(cost(), args, True, "static_edge_blocks (parent) cost")
    cg, hg = _graph_ms(rows)
    cc, hc = _graph_ms(cost)
    cp, hp = _graph_ms(lambda: lc.lm_cost_cuda(cost()[0], args[7]))
    print(f"[time] static_edge_blocks (parent, a thread an edge) E 8192 C "
          f"24 P 2048: Gauss-Newton cold {cg:.4f} ms (hot {hg:.4f}); cost "
          f"mode cold {cc:.4f} ms (hot {hc:.4f}); cost mode + lm_cost cold "
          f"{cp:.4f} ms (hot {hp:.4f})", flush=True)



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
    Gauss-Newton mode, then the shipped kernel's device time in each mode
    (the cost-sum mode replaces cost mode + lm_cost)."""
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



def main(argv=None) -> None:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an unpacked checkout of the commit before the "
                         "redesign of orb_desc and static_edge_blocks")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_split: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[split] card: {smi}", flush=True)
    csrc = REPO / "airdos_tpu_torch" / "csrc"
    split_pose(_build(pose_new((csrc / "pose_lm.cu").read_text()),
                      "pose_lm_split"), "pose_lm")
    fe = _front_end()
    split_select(_build(select_new((csrc / "select.cu").read_text()),
                        "select_split"), "select", fe)
    static = _static_problem(np.random.default_rng(1))
    if args.parent is not None:
        split_orb_parent(args.parent, fe)
    split_orb_new(fe)
    if args.parent is not None:
        split_static_parent(args.parent, static)
    split_static_new(static)


if __name__ == "__main__":
    os.chdir(REPO)
    main()
