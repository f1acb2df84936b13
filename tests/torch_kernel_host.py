"""A kernel source of airdos_tpu_torch/csrc compiled for the host, to check
its arithmetic on the CPU where there is no nvcc and no card.

The CUDA keywords become plain C++ (``__shared__`` a static, a block's
barrier a no-op, a warp shuffle adding nothing) and each block runs on one
thread: a kernel whose threads stride over their work by ``blockDim.x``
and sum by ``small_eig.cuh``'s block_sum then computes on that thread
what its block computes.  What this leaves unchecked (the shuffles, the
barriers, the launch) only the card tests reach.  The source's C entry
points, from the line ``// ---- launch`` on, are replaced by ``glue``:
host functions that call the kernel once a block.
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
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(x)
inline void __syncthreads() {}
template <class T> inline T __shfl_down_sync(unsigned, T, int) { return T(0); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int cudaGetLastError() { return 0; }
using std::isfinite;
"""

GLUE_HEAD = "Dim3 threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, blockDim{1, 1, 1};\n"


def build(source: str, glue: str, out_dir: Path) -> ctypes.CDLL:
    """csrc/<source> with its launch section replaced by glue, compiled
    with g++ into out_dir and loaded; skips the test without g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile a kernel source for the host")
    inc = out_dir / "inc"
    inc.mkdir(parents=True, exist_ok=True)
    (inc / "host_shim.h").write_text(SHIM)
    (inc / "cuda_runtime.h").write_text("#pragma once\n")
    text = (CSRC / source).read_text()
    text = text[:text.index("// ---- launch")]
    cpp = out_dir / (Path(source).stem + "_host.cpp")
    cpp.write_text('#include "host_shim.h"\n' + text + GLUE_HEAD + glue)
    lib = out_dir / ("lib" + Path(source).stem + "_host.so")
    res = subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC",
                          "-I", str(inc), "-I", str(CSRC), "-o", str(lib),
                          str(cpp)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return ctypes.CDLL(str(lib))


def call(fn, block: bytes) -> None:
    """fn(&params) with params the packed parameter block."""
    buf = ctypes.create_string_buffer(block)
    fn.argtypes = [ctypes.c_void_p]
    fn(ctypes.c_void_p(ctypes.addressof(buf)))
