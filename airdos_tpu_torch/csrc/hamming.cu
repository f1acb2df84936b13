// All-pairs 256-bit Hamming distance for ORB descriptors, for sm_90a.
//
// Replaces the Pallas TPU kernel airdos_tpu/ops/pallas_kernels.py
// (_hamming_kernel / hamming_matrix_pallas), which every matcher of the
// tracking path calls through hamming_matrix_auto: stereo (N = M = 1536
// slots at 1500 features), the motion-model projection match (1536 x 1536)
// and the local-map match (2048 x 1536).  The mapping pass reaches the
// same Pallas kernel under jax.vmap: triangulation (4 neighbours, 1536 x
// 1536 slots each, the new keyframe's descriptors shared) and fusion (8
// targets + the keyframe, 2048 points x 1536 slots, the point descriptors
// shared).
// Here the vmap is the grid's z dimension: one launch covers the batch,
// and a shared operand has a batch stride of 0.
//
// out[z, i, j] = sum_k popc(a[z, i, k] ^ b[z, j, k]) over the 8 32-bit
// words.
//
// What bounds it on an H100: the inputs are tiny (N*32 + M*32 bytes) and
// the int32 output is written once (N*M*4 bytes: 9.4 MB at 1536 x 1536,
// ~3 us at 3.35 TB/s).  The work is N*M*8 XOR + popc + add; popc issues
// at 16 per clock per SM on sm_90 (a quarter of the integer ALU rate), so
// the popc pipe, not memory, is the roofline: 1536 x 1536 x 8 = 18.9 M
// popc over 132 SMs x 16/clk is ~9k clocks, ~5 us at 1.75 GHz.
//
// Design: a block owns a 64 x 64 output tile.  Its 64 A rows and 64 B
// rows (8 words each, 2 KB apiece) are staged in shared memory once.  The
// 256 threads are laid out 64 (columns) x 4 (row groups): each thread keeps
// its B column's 8 words in registers and walks 16 A rows, reading each A
// word from shared memory as a warp-wide broadcast.  Stores go to 64
// consecutive columns, so each warp writes 128 contiguous bytes.  Bounds
// checks take any N and M (no multiple-of-128 rule as on the TPU).
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so that a refused
// launch is reported to the Python wrapper.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;
constexpr int kTileM = 64;   // output columns per block (threadIdx.x)
constexpr int kRowGroups = 4;  // threadIdx.y
constexpr int kTileN = 64;   // output rows per block
constexpr int kRowsPerThread = kTileN / kRowGroups;

__global__ void __launch_bounds__(kTileM * kRowGroups)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int32_t* __restrict__ out, int n, int m, int64_t stride_a,
               int64_t stride_b) {
  __shared__ uint32_t sa[kTileN][kWords];
  __shared__ uint32_t sb[kTileM][kWords];

  a += blockIdx.z * stride_a;
  b += blockIdx.z * stride_b;
  out += blockIdx.z * static_cast<int64_t>(n) * m;
  const int row0 = blockIdx.y * kTileN;
  const int col0 = blockIdx.x * kTileM;
  const int tid = threadIdx.y * kTileM + threadIdx.x;

  // 512 words per tile, 256 threads: two loads each per operand
  for (int e = tid; e < kTileN * kWords; e += kTileM * kRowGroups) {
    const int r = e / kWords, w = e % kWords;
    const int gr = row0 + r;
    sa[r][w] = gr < n ? a[static_cast<int64_t>(gr) * kWords + w] : 0u;
    const int gc = col0 + r;
    sb[r][w] = gc < m ? b[static_cast<int64_t>(gc) * kWords + w] : 0u;
  }
  __syncthreads();

  const int col = col0 + threadIdx.x;
  if (col >= m) return;
  uint32_t bw[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) bw[w] = sb[threadIdx.x][w];

#pragma unroll 4
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int r = threadIdx.y + k * kRowGroups;
    const int row = row0 + r;
    if (row >= n) break;
    int acc = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) acc += __popc(sa[r][w] ^ bw[w]);
    out[static_cast<int64_t>(row) * m + col] = acc;
  }
}

}  // namespace

// a: [batch or 1, n, 8], b: [batch or 1, m, 8] words, out: [batch, n, m];
// stride_a / stride_b are the operands' batch strides in words (0 for an
// operand shared by the whole batch).  The 2-D matrix is batch 1.
extern "C" int airdos_hamming_matrix_batched(const void* a, const void* b,
                                             void* out, int n, int m,
                                             int batch, int64_t stride_a,
                                             int64_t stride_b, void* stream) {
  if (n > 0 && m > 0 && batch > 0) {
    const dim3 block(kTileM, kRowGroups);
    const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN,
                    batch);
    hamming_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<int32_t*>(out), n, m, stride_a, stride_b);
  }
  return static_cast<int>(cudaGetLastError());
}
