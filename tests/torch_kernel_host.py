"""A kernel source of airdos_tpu_torch/csrc compiled for the host, to check
its arithmetic on the CPU where there is no nvcc and no card.

The CUDA keywords become plain C++ (``__shared__`` a static, a block's
or a warp's barrier a no-op, ``__shfl_down_sync`` adding nothing, the
other shuffles and votes a lane's own value) and each block runs on one
thread: a kernel whose threads stride over their work by ``blockDim.x``
and sum by ``small_eig.cuh``'s block_sum then computes on that thread
what its block computes.  ``AIRDOS_LANES`` is 1: a kernel that spreads
its work over the lanes of a warp (``small::kLanes``) or of a group runs
the same algorithm on one lane, its loops over lanes whole and its
shuffles across lanes never taken.  What this leaves unchecked (the
shuffles, the barriers) ``build(..., threaded=True)`` reaches: a
block's threads as threads, warps of 32 lanes (``THREADED_SHIM``); the
launch only the card tests reach.  The source's C entry points, from
the line ``// ---- launch`` on, are replaced by ``glue``: host functions
that call the kernel once a block.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parent.parent / "airdos_tpu_torch" / "csrc"

SHIM = r"""
#pragma once
#include <math.h>
#include <cmath>
#include <cstdint>
struct Dim3 { unsigned x, y, z; };
extern Dim3 threadIdx, blockIdx, blockDim;
#define AIRDOS_LANES 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __shared__ static
#define __launch_bounds__(x)
struct uint4 { unsigned x, y, z, w; };
inline void __syncthreads() {}
inline void __syncwarp(unsigned = 0xffffffffu) {}
template <class T> inline T __shfl_down_sync(unsigned, T, int) { return T(0); }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int, int = 32) { return v; }
template <class T> inline T __shfl_sync(unsigned, T v, int, int = 32) { return v; }
inline int __any_sync(unsigned, int p) { return p; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <class T> inline T __ldg(const T* p) { return *p; }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
inline int cudaGetLastError() { return 0; }
using std::isfinite;
"""

GLUE_HEAD = "Dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};\n"

# The threaded build: a block's threads are std::threads, each with its
# own threadIdx, and warps of 32 lanes (AIRDOS_LANES left at 32).  A
# barrier stands for __syncthreads, one a (warp, lane mask) for
# __syncwarp and the shuffles and votes, which pass values through a slot
# a thread between two waits.  Glue launches a block with
# run_block(threads, body); blocks run one after another.  It runs the
# lanes' own algorithm, and a lane that reads before its warp's barrier
# races as it would on the card.
THREADED_SHIM = r"""
#pragma once
#include <math.h>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <barrier>
#include <map>
#include <mutex>
#include <thread>
#include <vector>
struct Dim3 { unsigned x, y, z; };
extern thread_local Dim3 threadIdx;
extern Dim3 blockIdx, blockDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __shared__ static
#define __launch_bounds__(x)
struct uint4 { unsigned x, y, z, w; };
struct Emu {
  std::barrier<>* block = nullptr;
  std::mutex mu;
  std::map<unsigned long long, std::barrier<>*> bars;   // (warp, mask)
  unsigned long long slot[1024];
};
extern Emu g_emu;
inline std::barrier<>* bar_of(unsigned mask) {
  const unsigned long long key =
      (static_cast<unsigned long long>(threadIdx.x / 32) << 32) | mask;
  std::lock_guard<std::mutex> g(g_emu.mu);
  auto it = g_emu.bars.find(key);
  if (it != g_emu.bars.end()) return it->second;
  auto* b = new std::barrier<>(__builtin_popcount(mask));
  g_emu.bars[key] = b;
  return b;
}
inline void __syncthreads() { g_emu.block->arrive_and_wait(); }
inline void __syncwarp(unsigned mask = 0xffffffffu) { bar_of(mask)->arrive_and_wait(); }
template <class T> inline T exchange(unsigned mask, T v, int src) {
  unsigned long long u = 0;
  std::memcpy(&u, &v, sizeof(T));
  g_emu.slot[threadIdx.x] = u;
  bar_of(mask)->arrive_and_wait();
  T r;
  const unsigned long long o = g_emu.slot[(threadIdx.x & ~31u) + src];
  std::memcpy(&r, &o, sizeof(T));
  bar_of(mask)->arrive_and_wait();
  return r;
}
template <class T> inline T __shfl_down_sync(unsigned mask, T v, int off) {
  const int lane = threadIdx.x & 31;
  return exchange(mask, v, lane + off < 32 ? lane + off : lane);
}
template <class T> inline T __shfl_xor_sync(unsigned mask, T v, int off, int = 32) {
  return exchange(mask, v, (threadIdx.x & 31) ^ off);
}
template <class T> inline T __shfl_sync(unsigned mask, T v, int src, int = 32) {
  return exchange(mask, v, src);
}
inline int __any_sync(unsigned mask, int p) {
  g_emu.slot[threadIdx.x] = p ? 1 : 0;
  bar_of(mask)->arrive_and_wait();
  int any = 0;
  for (int l = 0; l < 32; ++l)
    if (mask >> l & 1) any |= g_emu.slot[(threadIdx.x & ~31u) + l] != 0;
  bar_of(mask)->arrive_and_wait();
  return any;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
template <class T> inline T __ldg(const T* p) { return *p; }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
inline int cudaGetLastError() { return 0; }
using std::isfinite;
template <class F> void run_block(unsigned threads, F body) {
  blockDim = {threads, 1, 1};
  std::barrier<> b(threads);
  g_emu.block = &b;
  for (auto& kv : g_emu.bars) delete kv.second;
  g_emu.bars.clear();
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < threads; ++t)
    ts.emplace_back([t, &body] { threadIdx = {t, 0, 0}; body(); });
  for (auto& t : ts) t.join();
}
"""

THREADED_HEAD = ("thread_local Dim3 threadIdx{0, 0, 0};\n"
                 "Dim3 blockIdx{0, 0, 0}, blockDim{1, 1, 1};\nEmu g_emu;\n")


def build(source: str, glue: str, out_dir: Path,
          threaded: bool = False) -> ctypes.CDLL:
    """csrc/<source> with its launch section replaced by glue, compiled
    with g++ into out_dir and loaded (threaded: lanes as threads, above);
    skips the test without g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile a kernel source for the host")
    inc = out_dir / "inc"
    inc.mkdir(parents=True, exist_ok=True)
    (inc / "host_shim.h").write_text(THREADED_SHIM if threaded else SHIM)
    (inc / "cuda_runtime.h").write_text("#pragma once\n")
    text = (CSRC / source).read_text()
    text = text[:text.index("// ---- launch")]
    cpp = out_dir / (Path(source).stem + "_host.cpp")
    cpp.write_text('#include "host_shim.h"\n' + text +
                   (THREADED_HEAD if threaded else GLUE_HEAD) + glue)
    lib = out_dir / ("lib" + Path(source).stem + "_host.so")
    flags = ["-std=c++20", "-pthread"] if threaded else ["-std=c++17"]
    res = subprocess.run([cxx, "-O1", *flags, "-shared", "-fPIC",
                          "-I", str(inc), "-I", str(CSRC), "-o", str(lib),
                          str(cpp)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return ctypes.CDLL(str(lib))


def call(fn, block: bytes) -> None:
    """fn(&params) with params the packed parameter block."""
    buf = ctypes.create_string_buffer(block)
    fn.argtypes = [ctypes.c_void_p]
    fn(ctypes.c_void_p(ctypes.addressof(buf)))
