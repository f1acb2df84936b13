// Deterministic sorted-segment sum for the local BA's normal equations,
// for sm_90a.
//
// Replaces the five XLA scatter-adds of airdos_tpu/solvers/local_ba.py
// (gn_step, lines 119-142), which the port makes three launches per
// Gauss-Newton step: the camera blocks Hcc and bc side by side (42
// columns keyed by the edge's camera), the point blocks Hpp and bp (12
// columns keyed by its point) and the camera-point coupling Wagg (18
// columns keyed by point * C + camera).  They are not Pallas kernels; the
// kernel exists for correctness.  On CUDA a float index_add_ /
// scatter_add_ sums with atomics in an order that changes from run to
// run, and offline runs must be byte-identical (the JAX package's
// tests/test_determinism.py and the SaveMap golden dumps).
//
// out[s, c] = sum of vals[perm[i], c] for i in [offsets[s], offsets[s+1]),
// summed from 0.0f in that order.  perm is a stable sort of the edges by
// segment key, made once per BA call (the edge table is fixed across its
// 15 Gauss-Newton steps), so each segment sums its rows in edge order: the
// order of index_add_ on the CPU, to which the result is bit-equal.  Each
// column is its own chain, so columns placed side by side sum exactly as
// they would alone.  Empty segments get 0.0f.  No atomics.
//
// What bounds it on an H100.  The bytes are few: a launch reads each row
// of a segment once (kept rows x k x 4 B: ~1.2 MB for the camera blocks)
// plus perm and the offsets, and writes S x k floats (49152 x 18 x 4 B =
// 3.5 MB for Wagg): about 0.1-1.2 us of HBM time at 3.35 TB/s.  The order
// is the other bound: each (segment, column) sum is a chain of dependent
// adds, ~4 clocks each when its operands are on chip, so a segment of 400
// rows needs ~1 us whatever the card's width.
//
// Two launch shapes, picked from the rows, segments and columns alone (no
// segment length is read on the host):
// - many short segments (the point-keyed sums: 1-3 rows each): one thread
//   per (segment, column) loads its rows straight from global memory;
//   neighbouring threads are neighbouring columns of one row, so the row
//   loads are coalesced.  A launch lasts a few dependent loads.
// - few long segments (the camera-keyed sums: ~400 rows, 24 segments):
//   one block per segment.  The block stages a chunk of the segment's
//   perm, then the chunk's rows (cp.async, every thread issuing copies of
//   consecutive floats, all in flight at once) in dynamic shared memory,
//   and then thread c sums column c over the chunk in row order with
//   __fadd_rn.  The chain is fed from shared memory, not by two dependent
//   global loads a row (perm, then the row: ~70 ns a row on this card).
//   A chunk holds 96 KB, 571 rows at 42 columns: a camera segment is one
//   chunk.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStageBytes = 96 * 1024;  // dynamic shared memory, staged
constexpr int kMinMeanRows = 32;        // staged from this many rows a segment

__global__ void __launch_bounds__(kThreads)
segment_sum_rows_kernel(const float* __restrict__ vals,
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

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// One block per segment; k <= kThreads.  Shared memory: chunk_rows perm
// entries, then chunk_rows x k floats.
__global__ void __launch_bounds__(kThreads)
segment_sum_staged_kernel(const float* __restrict__ vals,
                          const int32_t* __restrict__ perm,
                          const int32_t* __restrict__ offsets,
                          float* __restrict__ out, int k, int chunk_rows) {
  extern __shared__ float smem[];
  int32_t* sperm = reinterpret_cast<int32_t*>(smem);
  float* srows = smem + chunk_rows;
  const int s = blockIdx.x;
  const int begin = offsets[s];
  const int end = offsets[s + 1];
  const int tid = threadIdx.x;
  // the element walk below steps kThreads floats: kThreads / k rows and
  // kThreads % k columns
  const int row_step = kThreads / k;
  const int col_step = kThreads % k;
  float acc = 0.0f;
  for (int r0 = begin; r0 < end; r0 += chunk_rows) {
    const int rows = min(chunk_rows, end - r0);
    for (int r = tid; r < rows; r += kThreads) sperm[r] = perm[r0 + r];
    __syncthreads();
    // chunk element e = r * k + c: consecutive threads copy consecutive
    // floats of one row
    int r = tid / k;
    int c = tid - r * k;
    for (int e = tid; e < rows * k; e += kThreads) {
      cp_async4(srows + e, vals + static_cast<int64_t>(sperm[r]) * k + c);
      r += row_step;
      c += col_step;
      if (c >= k) {
        c -= k;
        ++r;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (tid < k) {
      // in order, one add at a time: float addition is not associative
#pragma unroll 8
      for (int i = 0; i < rows; ++i) acc = __fadd_rn(acc, srows[i * k + tid]);
    }
    __syncthreads();  // the chunk is read before the next one lands
  }
  if (tid < k) out[static_cast<int64_t>(s) * k + tid] = acc;
}

}  // namespace

// vals: [n_rows, k] float32 row-major; perm: [n_rows] int32; offsets:
// [n_seg + 1] int32; out: [n_seg, k] float32.
extern "C" int airdos_segment_sum(const void* vals, const void* perm,
                                  const void* offsets, void* out, int n_rows,
                                  int n_seg, int k, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const float*>(vals);
  const auto* p = static_cast<const int32_t*>(perm);
  const auto* o = static_cast<const int32_t*>(offsets);
  auto* d = static_cast<float*>(out);
  if (n_seg <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  if (k <= kThreads &&
      static_cast<int64_t>(n_rows) >= static_cast<int64_t>(kMinMeanRows) * n_seg) {
    const int chunk_rows = kStageBytes / (4 * (k + 1));
    // above 48 KB of dynamic shared memory needs the opt-in, once a device
    static bool opted_in[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 64 || !opted_in[dev]) {
      err = cudaFuncSetAttribute(segment_sum_staged_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kStageBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < 64) opted_in[dev] = true;
    }
    segment_sum_staged_kernel<<<n_seg, kThreads, 4 * chunk_rows * (k + 1),
                                st>>>(v, p, o, d, k, chunk_rows);
  } else {
    const int64_t blocks =
        (static_cast<int64_t>(n_seg) * k + kThreads - 1) / kThreads;
    segment_sum_rows_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                              st>>>(v, p, o, d, n_seg, k);
  }
  return static_cast<int>(cudaGetLastError());
}
