"""match_rows (csrc/match.cu) on the card: every mode against its plain
version on tests/torch_match_cases.py's seeded inputs, and its device and
host times under the settings of its grid of cells.

    python3 tools/match_grid.py [--quick | --split | --cluster]

Run from the repository root on a CUDA machine (~2 min; --quick: step 1
alone, ~30 s; --split: step 1, then each path case's device time without
the rows' walks, without the resolve and without both; --cluster: step
1, then each path case's device time with the grid of cells built by
every block, as shipped, and by the first block of a cluster of 8 whose
other blocks copy its table through distributed shared memory, a variant
of csrc/match.cu written and built at run time into _build/variants/).  Prints, beside the card's name and power limit:

1. check: every mode on every case of tests/torch_match_cases.py at 48 x
   96 (fuse: B = 3) and on the "path" and "wide windows" cases at the
   path's shapes (stereo, motion, BoW 1536 x 1536, local 2048 x 1536,
   fuse B = 9 and 1 x 2048 x 1536, epipolar B = 4 x 1536 x 1536): every
   output bit-equal to
   match_rows_ref on the card, two
   launches equal; under the grid of csrc/match.cu's defaults and under a
   single cell (the full scan);
2. grid: each mode's device time at its path shape (chip_smoke.py's CUDA
   graph of 100 launches, L2 cold and hot) under grids of 1 x 1 (the full
   scan; epipolar: the exact gate at every pair), 32 x 24, 64 x 48 and
   128 x 96 cells, BoW under 1, 64, 256 and
   1024 buckets, and under 2, 3, 4 and 8 blocks an SM;
3. host: the wrapper's host time a call (the median of 200 calls, the
   inputs checked and not) beside its device time;
4. fusion's eager composition (its gate and reductions around the batched
   Hamming kernel, which fusion ran before fuse mode) at B = 9 and 1 x
   2048 x 1536, per call (CUDA events), beside fuse mode's.
"""
import statistics
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from chip_smoke import _cuda_ms, _graph_ms, _nvidia_smi  # noqa: E402

PATH_SHAPES = {"stereo": (1536, 1536, 1), "motion": (1536, 1536, 1),
               "local": (2048, 1536, 1), "bow": (1536, 1536, 1),
               "fuse": (2048, 1536, 9), "epipolar": (1536, 1536, 4)}


def _equal(mk, args, label):
    import torch
    got = mk.match_rows_cuda(*args)
    again = mk.match_rows_cuda(*args)
    want = mk.match_rows_ref(*args)
    torch.cuda.synchronize()
    for name in mk.RowMatches._fields:
        g, w = getattr(got, name), getattr(want, name)
        if not torch.equal(g, w):
            bad = int((g != w).sum()) if g.shape == w.shape else -1
            raise SystemExit(f"match_grid: FAIL: {label}: {name} differs "
                             f"from the plain version ({bad} entries)")
        if not torch.equal(g, getattr(again, name)):
            raise SystemExit(f"match_grid: FAIL: {label}: two launches "
                             f"differ in {name}")
    return got


def split(mk, path):
    """Each path case's device time with its parts taken away: the rows'
    walks (every row not valid), the resolve (motion, local, bow), both."""
    for (mode, b), args in path.items():
        rows = args[1]
        off = args[:1] + (rows._replace(ok=rows.ok & False),) + args[2:]
        row = []
        for label, a in (("as is", args), ("no walk", off)):
            for resolve in ((True, False) if args[7] else (False,)):
                x = a[:7] + (resolve, a[8] if resolve else None) + a[9:]
                cold, hot = _graph_ms(lambda: mk.match_rows_cuda(*x))
                row.append(f"{label}{'' if resolve or not args[7] else ', no resolve'}"
                           f" {cold:.4f} ({hot:.4f})")
        print(f"[match_grid] split {mode} B={b}: device ms cold (hot): "
              + "; ".join(row), flush=True)


# the cluster variant of csrc/match.cu: in a cluster of 8 blocks the
# first builds the grid of cells and the others copy its table from its
# shared memory (distributed shared memory), instead of each block
# building its own; written and built at run time, never shipped
CLUSTER = 8
_CLUSTER_EDITS = (
    ("#include <cuda_runtime.h>",
     "#include <cuda_runtime.h>\n#include <cooperative_groups.h>"),
    ("  build_table<MODE>(q, b, t, rotation, sgrid);", """  {
    namespace cg = cooperative_groups;
    cg::cluster_group cl = cg::this_cluster();
    if (cl.block_rank() == 0) build_table<MODE>(q, b, t, rotation, sgrid);
    cl.sync();
    if (cl.block_rank() != 0) {
      const uint4* src = reinterpret_cast<const uint4*>(
          cl.map_shared_rank(smem, 0));
      const size_t n = table_bytes(q.n_cols, cells) / 16;
      for (size_t i = threadIdx.x; i < n; i += kThreads)
        reinterpret_cast<uint4*>(smem)[i] = src[i];
      if (threadIdx.x == 0) sgrid = *cl.map_shared_rank(&sgrid, 0);
    }
    cl.sync();
  }"""),
    ("  const dim3 grid(static_cast<unsigned>(q.blocks),",
     "  const dim3 grid(static_cast<unsigned>((q.blocks + %d) / %d * %d),"
     % (CLUSTER - 1, CLUSTER, CLUSTER)),
    ("  match_rows_kernel<MODE><<<grid, kThreads, smem, s>>>(q);", """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = %d;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, match_rows_kernel<MODE>, q);
  if (err != cudaSuccess) return static_cast<int>(err);""" % CLUSTER),
)


def cluster_library(mk):
    """csrc/match.cu's cluster variant, built into _build/variants/."""
    from airdos_tpu_torch.ops import cuda_build
    src = mk._SOURCE.read_text()
    for old, new in _CLUSTER_EDITS:
        if src.count(old) != 1:
            raise SystemExit(f"match_grid: the cluster variant's edit does not "
                             f"apply: {old!r}")
        src = src.replace(old, new)
    out = cuda_build.BUILD_DIR / "variants" / "match_cluster.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return cuda_build.library(out, mk._SIGNATURES)


def cluster(mk, path, smi):
    """Each path case's device time with the grid built by each block and
    by the first block of a cluster of 8 (the others copying its table),
    both bit-equal to the plain version."""
    shipped = mk._library()
    variant = cluster_library(mk)
    for (mode, b), args in path.items():
        row = []
        for label, lib in (("each block", shipped), ("cluster", variant)):
            mk._lib = lib
            _equal(mk, args, f"{mode} {label}")
            cold, hot = _graph_ms(lambda: mk.match_rows_cuda(*args))
            row.append(f"{label} {cold:.4f} ({hot:.4f})")
        mk._lib = shipped
        print(f"[match_grid] grid build {mode} B={b}: device ms cold (hot): "
              + ", ".join(row) + f" on {smi}", flush=True)


def main(argv):
    import torch
    import torch_match_cases as tc

    import airdos_tpu_torch.ops.match_kernels as mk
    if not torch.cuda.is_available():
        raise SystemExit("match_grid: needs a CUDA device")
    smi = _nvidia_smi()
    print(f"[match_grid] {smi}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    mk.build()
    print(f"[match_grid] built match.cu in {time.perf_counter() - t0:.2f} s",
          flush=True)
    dev = torch.device("cuda")
    defaults = dict(mk.CELLS)

    # 1. check
    n = 0
    for m, mode in enumerate(tc.MODES):
        for case in tc.CASES:
            rng = np.random.default_rng(1000 * m + tc.CASES.index(case))
            args = tc.args(tc.make(m, case, rng, 48, 96, 3), dev)
            for cells in (defaults[m], (1, 1)):
                mk.CELLS[m] = cells
                _equal(mk, args, f"{mode} {case} {cells}")
                n += 1
        mk.CELLS[m] = defaults[m]
    path = {}
    for m, mode in enumerate(tc.MODES):
        P, N, B = PATH_SHAPES[mode]
        for b, case in [(b, "path") for b in ((B, 1) if mode == "fuse"
                                              else (B,))] + [(B, "wide windows")]:
            rng = np.random.default_rng(7 + m)
            args = tc.args(tc.make(m, case, rng, P, N, b), dev)
            got = _equal(mk, args, f"{mode} {case} {b} x {P} x {N}")
            path[(mode if case == "path" else f"{mode} wide", b)] = args
            print(f"[match_grid] {mode} {case} B={b} {P}x{N}: bit-equal, "
                  f"{int(got.has.sum())} rows matched, "
                  f"{int(mk.gate(m, args[1], args[2], args[5], args[6], args[9]).sum())}"
                  f" gated pairs", flush=True)
            n += 1
    print(f"[match_grid] check: {n} calls bit-equal to the plain version, "
          f"two launches equal", flush=True)
    if argv == ["--quick"]:
        return
    if argv == ["--split"]:
        split(mk, path)
        return
    if argv == ["--cluster"]:
        cluster(mk, path, smi)
        return

    # 2. grid
    def times(args):
        cold, hot = _graph_ms(lambda: mk.match_rows_cuda(*args))
        return f"{cold:.4f} ({hot:.4f})"

    for (mode, b), args in path.items():
        m = tc.MODES.index(mode.split()[0])
        grids = ((1, 1), (64, 1), (256, 1), (1024, 1)) if mode == "bow" \
            else ((1, 1), (32, 24), (64, 48), (128, 96))
        row = []
        for cells in grids:
            mk.CELLS[m] = cells
            _equal(mk, args, f"{mode} {cells}")
            row.append(f"{cells[0]}x{cells[1]} {times(args)}")
        mk.CELLS[m] = defaults[m]
        print(f"[match_grid] {mode} B={b}: device ms cold (hot) by grid: "
              + ", ".join(row), flush=True)
        row = []
        for per_sm in (2, 3, 4, 8):
            mk.BLOCKS_PER_SM = per_sm
            row.append(f"{per_sm} {times(args)}")
        mk.BLOCKS_PER_SM = 3
        print(f"[match_grid] {mode} B={b}: device ms cold (hot) by blocks "
              f"an SM: " + ", ".join(row), flush=True)

    # 3. host
    for (mode, b), args in path.items():
        host = {}
        for check in (True, False):
            calls = []
            for _ in range(200):
                t = time.perf_counter()
                mk.match_rows_cuda(*args, check)
                calls.append(time.perf_counter() - t)
                torch.cuda.synchronize()
            host[check] = statistics.median(calls) * 1e3
        cold, hot = _graph_ms(lambda: mk.match_rows_cuda(*args))
        print(f"[match_grid] {mode} B={b}: host ms a call {host[True]:.4f} "
              f"checked, {host[False]:.4f} not; device {cold:.4f} cold, "
              f"{hot:.4f} hot", flush=True)

    # 4. fusion's eager composition
    from airdos_tpu_torch.ops import hamming_kernels as hk
    for b in (9, 1):
        args = path[("fuse", b)]
        _, rows, cols, th = args[:4]
        sigma2 = args[9]

        def composition():
            ok = mk.gate(mk.FUSE, rows, cols, None, 0.0, sigma2)
            D = hk.hamming_matrix_batched(rows.desc[None], cols.desc)
            D = torch.where(ok, D, torch.full_like(D, mk.BIG))
            return mk.reduce_gated(mk.FUSE, D, None, None, th, 0.0)

        want = composition()
        got = mk.match_rows_cuda(*args)
        torch.cuda.synchronize()
        if not (torch.equal(want.feat_idx, got.feat_idx)
                and torch.equal(want.dist, got.dist)):
            raise SystemExit("match_grid: FAIL: fuse mode != the composition")
        print(f"[match_grid] fuse B={b}: per call ms: kernel "
              f"{_cuda_ms(lambda: mk.match_rows_cuda(*args)):.4f}, the eager "
              f"composition around the batched Hamming kernel "
              f"{_cuda_ms(composition):.4f} on {smi}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
