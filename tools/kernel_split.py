"""Where a launch of pose_lm or select spends its time on the card, from
clock64() stamps in an instrumented copy of the kernel's source.

    python3 tools/kernel_split.py [--parent DIR]

Run from the repository root on a CUDA machine.  The copies are written at
run time into airdos_tpu_torch/_build/split/ (the kernels in csrc/ carry no
stamps): each stamp is inserted after a fixed line of the source, the copy
is built with the port's nvcc command and launched through its own C entry
point on the inputs below, and the stamps of the leader block's thread 0
are summed in shared memory and read once a launch.

- pose_lm (csrc/pose_lm.cu) at N 1536 (200 mono edges, prior off) and N
  640: cycles a step in the block's own pass, the wait for its block's
  other warps, the exchange of the sums between the cluster's blocks, the
  LM step's tail and the barrier after it;
- select (csrc/select.cu) at 8 levels of a 640x360 textured image (1500
  features): cycles of level 0's leader in the scan with the two cluster
  barriers, the ranks, the sort and the slots.

With --parent DIR (a `git archive` of the commit before the redesign
unpacked in DIR), also the one-block pose_lm.cu from DIR at the same N:
cycles a step in the pass, the block reduction and thread 0's tail.  Each copy's
result is held against the plain version (R and t within 1e-4; select
bit-equal); the split is printed beside the launch's time (CUDA events)
and the card's name and power limit.
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


def pose_parent(src: str) -> str:
    """The one-block csrc/pose_lm.cu: slots 0-2 per step (pass, reduction, tail),
    3 steps, 4 the launch."""
    return _insert(src, [
        ("namespace {\n", HEAD),
        ("  float acc[kRed];\n#pragma unroll\n  for (int k = 0; k < kRed; ++k) acc[k] = 0.0f;\n",
         "  __shared__ long long s_wend[kWarps];\n  const long long t_start = clock64();\n"
         "  float acc[kRed];\n#pragma unroll\n  for (int k = 0; k < kRed; ++k) acc[k] = 0.0f;\n"),
        ("    acc[28] += 1.0f;\n  }\n  block_sum<kRed>(acc, red, tot);\n}",
         "    acc[28] += 1.0f;\n  }\n"
         "  if ((threadIdx.x & 31) == 0) s_wend[threadIdx.x >> 5] = clock64();\n"
         "  block_sum<kRed>(acc, red, tot);\n  if (threadIdx.x == 0) {\n"
         "    long long mx = 0;\n"
         "    for (int w = 0; w < kWarps; ++w) mx = s_wend[w] > mx ? s_wend[w] : mx;\n"
         "    const long long now = clock64();\n"
         "    s_split[0] += mx - t_start; s_split[1] += now - mx;\n"
         "    s_split[7] = now; s_split[3] += 1;\n  }\n}"),
        ("  const bool lead = threadIdx.x == 0;\n",
         "  const bool lead = threadIdx.x == 0;\n  const long long t_kernel = clock64();\n"
         "  if (lead) for (int k = 0; k < 8; ++k) s_split[k] = 0;\n"),
        ("      propose(s);\n    }\n    __syncthreads();\n",
         "      propose(s);\n    }\n    __syncthreads();\n"
         "    if (lead) s_split[2] += clock64() - s_split[7];\n"),
        ("        if (it + 1 < kIters) propose(s);\n      }\n      __syncthreads();\n",
         "        if (it + 1 < kIters) propose(s);\n      }\n      __syncthreads();\n"
         "      if (lead) s_split[2] += clock64() - s_split[7];\n"),
        ("  if (lead) {\n    for (int k = 0; k < 9; ++k) out[k] = s.R[k];",
         "  if (lead) {\n    s_split[4] = clock64() - t_kernel;\n"
         "    for (int k = 0; k < 8; ++k) g_split[k] += s_split[k];\n  }\n"
         "  if (lead) {\n    for (int k = 0; k < 9; ++k) out[k] = s.R[k];"),
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


def _build(text: str, name: str) -> ctypes.CDLL:
    from airdos_tpu_torch.ops import cuda_build
    out_dir = cuda_build.BUILD_DIR / "split"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(text)
    lib = out_dir / f"lib{name}.so"
    cmd = [cuda_build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
           str(lib), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"nvcc failed on {name}:\n{res.stderr}")
    dll = ctypes.CDLL(str(lib))
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


def split_pose(dll, name: str, parent: bool) -> None:
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
        if parent:
            steps = acc[3]
            parts = (("pass", acc[0]), ("reduction", acc[1]), ("tail", acc[2]))
            launch_cycles = acc[4]
        else:
            steps = acc[5]
            parts = (("own pass", acc[0]), ("block's warps", acc[1]),
                     ("exchange", acc[2]), ("tail", acc[3]),
                     ("barrier", acc[4]))
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


def split_select(dll, name: str) -> None:
    import torch
    import airdos_tpu_torch.ops.select as sk
    from airdos_tpu_torch.features.orb import (MIN_BORDER, _cell_size_for,
                                               level_quotas)
    from airdos_tpu_torch.ops import fast, pyramid
    img = torch.from_numpy(_texture(np.random.default_rng(5), 360, 640))
    pyr = pyramid.build_pyramid(img.cuda(), None, 8, 1.2)
    maps = [fast.fast_nms(im, m, 7.0, 16)
            for im, m in zip(pyr.images, pyr.masks)]
    quotas = level_quotas(1500, 8, 1.2)
    cells = [_cell_size_for(s.shape[0] - 2 * MIN_BORDER,
                            s.shape[1] - 2 * MIN_BORDER, q)
             for s, q in zip(maps, quotas)]
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


def main(argv=None) -> None:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an unpacked checkout of the commit before the "
                         "redesign, for the one-block pose_lm.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_split: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[split] card: {smi}", flush=True)
    csrc = REPO / "airdos_tpu_torch" / "csrc"
    split_pose(_build(pose_new((csrc / "pose_lm.cu").read_text()),
                      "pose_lm_split"), "pose_lm", parent=False)
    if args.parent is not None:
        old = args.parent / "airdos_tpu_torch" / "csrc" / "pose_lm.cu"
        split_pose(_build(pose_parent(old.read_text()), "pose_lm_parent_split"),
                   "pose_lm (parent)", parent=True)
    split_select(_build(select_new((csrc / "select.cu").read_text()),
                        "select_split"), "select")


if __name__ == "__main__":
    os.chdir(REPO)
    main()
