// The LM cost of one edge family in one launch, for sm_90a: the sum of
// where(isfinite(rho), rho, 1e30) * active over the family's edges, in a
// fixed order.
//
// Replaces the cost sums of airdos_tpu/solvers/local_ba.py:176-182 and
// airdos_tpu/solvers/human_ba.py:223-243 (XLA reductions, in XLA's order).
// The port's plain version is ops/lm_cost.py lm_cost_ref.  One block of
// 1024 threads: thread j adds the terms j, j + 1024, j + 2048, ... in
// sequence from 0 (each term the guarded rho times active, one
// __fmul_rn), then the 1024 partials are added in a halving tree in
// shared memory, partial j + partial j + 512, then 256, ..., 1.  The plain
// version pads the terms with zeros to a multiple of 1024 (a zero adds
// exactly), adds the [n / 1024, 1024] rows in sequence and halves ten
// times, one eager add each: every sum is the same __fadd_rn in the same
// order, so the two are bit-equal, and a card run repeats itself bit for
// bit.
//
// What bounds it on an H100.  Bytes: 8 an edge (rho and active), 64 kB at
// E = 8192, ~0.02 us at 3.35 TB/s; 2 operations an edge.  Neither: one
// block on one SM, its chain of n / 1024 dependent loads and adds and
// the tree's ten synchronised steps, a few microseconds, are the time;
// the launch costs as much.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
lm_cost_kernel(const float* __restrict__ rho,
               const float* __restrict__ active, int n,
               float* __restrict__ out) {
  __shared__ float partial[kThreads];
  const int j = threadIdx.x;
  float acc = 0.0f;
  for (int i = j; i < n; i += kThreads) {
    const float r = rho[i];
    acc = __fadd_rn(acc, __fmul_rn(isfinite(r) ? r : 1e30f, active[i]));
  }
  partial[j] = acc;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (j < half) partial[j] = __fadd_rn(partial[j], partial[j + half]);
    __syncthreads();
  }
  if (j == 0) *out = partial[0];
}

}  // namespace

// rho, active [n] float32; out: one float32.
extern "C" int airdos_lm_cost(const void* rho, const void* active, int n,
                              void* out, void* stream) {
  lm_cost_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rho), static_cast<const float*>(active),
      n < 0 ? 0 : n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
