// Deterministic sorted-segment sum for the local BA's normal equations,
// for sm_90a.
//
// Replaces the five XLA scatter-adds of airdos_tpu/solvers/local_ba.py
// (gn_step, lines 119-142): the camera blocks Hcc and bc (keyed by the
// edge's camera), the point blocks Hpp and bp (keyed by its point) and the
// camera-point coupling Wagg (keyed by point * C + camera).  They are not
// Pallas kernels; the kernel exists for correctness.  On CUDA a float
// index_add_ / scatter_add_ sums with atomics in an order that changes
// from run to run, and offline runs must be byte-identical (the JAX
// package's tests/test_determinism.py and the SaveMap golden dumps).
//
// out[s, c] = sum of vals[perm[i], c] for i in [offsets[s], offsets[s+1]),
// summed from 0.0f in that order.  perm is a stable sort of the edges by
// segment key, made once per BA call (the edge table is fixed across its
// 15 Gauss-Newton steps), so each segment sums its rows in edge order: the
// order of index_add_ on the CPU, to which the result is bit-equal.  Empty
// segments get 0.0f.  No atomics.
//
// What bounds it on an H100.  The bytes are few: a launch reads each edge
// row once (E * K * 4 B: 8192 edges x 36 floats = 1.2 MB for Hcc, at
// most) plus perm and the offsets, and writes S * K floats (49152 x 18 x
// 4 B = 3.5 MB for Wagg), about 1-2 us of HBM time.  The order is the
// real bound: each (segment, column) sum is a serial chain in one thread,
// so a launch lasts as long as its longest segment (chip_smoke.py's kernel
// phase prints the device time per row of it).  In the BA a camera segment
// holds several hundred rows; point and (point, camera) segments hold a
// few, because the padding and invalid edges belong to no segment (see
// make_segments in ops/segment_kernels.py).  The loop is plain: unrolling
// it with the loads issued ahead of the adds is left to a later change.
// One thread per (segment, column): neighbouring threads are
// neighbouring columns of one row, so the row loads are coalesced and the
// perm load is a broadcast.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ vals,
                   const int32_t* __restrict__ perm,
                   const int32_t* __restrict__ offsets,
                   float* __restrict__ out, int n_seg, int k) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(n_seg) * k) return;
  const int s = static_cast<int>(idx / k);
  const int c = static_cast<int>(idx % k);
  float acc = 0.0f;
  // in order, one add at a time: float addition is not associative
  for (int i = offsets[s]; i < offsets[s + 1]; ++i) {
    acc = __fadd_rn(acc, vals[static_cast<int64_t>(perm[i]) * k + c]);
  }
  out[idx] = acc;
}

}  // namespace

// vals: [n_rows, k] float32 row-major; perm: [n_rows] int32; offsets:
// [n_seg + 1] int32; out: [n_seg, k] float32.
extern "C" int airdos_segment_sum(const void* vals, const void* perm,
                                  const void* offsets, void* out, int n_seg,
                                  int k, void* stream) {
  const int64_t total = static_cast<int64_t>(n_seg) * k;
  if (total > 0) {
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    segment_sum_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), static_cast<const int32_t*>(perm),
        static_cast<const int32_t*>(offsets), static_cast<float*>(out), n_seg,
        k);
  }
  return static_cast<int>(cudaGetLastError());
}
