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
// words, computed as popc(a_i) + popc(b_j) - 2 popc(a_i & b_j): exact
// integer arithmetic.
//
// What bounds it on an H100: the inputs are tiny (N*32 + M*32 bytes) and
// the int32 output is written once (N*M*4 bytes: 9.4 MB at 1536 x 1536,
// 2.8 us at 3.35 TB/s), so the output write is the roofline.  The bit work
// (N*M*256 AND + popcount) would take ~5 us on the integer pipe (popc
// issues at 16 per clock per SM), which is why it goes to the tensor
// cores: one binary MMA, mma.sync m16n8k256 .b1 .and.popc, gives a 16 x 8
// tile of popc(a & b) over the whole 256-bit descriptor (k = 256).
//
// Design: a block owns a 64 x 128 output tile.  Its 64 A rows and 128 B
// rows (8 words each) are staged in shared memory as 16-byte loads, with
// one popcount per row.  Each of the 8 warps takes 16 rows x 64 columns:
// one A fragment (4 registers: rows g and g + 8, words t and t + 4 of lane
// (g, t)) and 8 MMAs against B fragments (2 registers: column g, words t
// and t + 4).  The warp stages its 16 x 64 distances in its own padded
// slice of shared memory and writes them out as 16-byte stores, two
// 256-byte row segments per store instruction, with no block barrier
// between the MMAs and the stores.  The ragged edge (N or M not a
// multiple of the tile, M not a multiple of 4) is zero-padded on the way
// in and stored element by element on the way out: any N and M (no
// multiple-of-128 rule as on the TPU).  The operands' rows start on 16
// bytes (the wrapper copies an operand that does not).
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so that a refused
// launch is reported to the Python wrapper.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;
constexpr int kTileN = 64;               // output rows per block: 4 warps x 16
constexpr int kTileM = 128;              // output columns per block: 2 x 64
constexpr int kThreads = 256;
constexpr int kWarpStride = 64 + 8;      // ints; the pad spreads the banks

// d = popc(a & b) summed over k = 256 for a 16 x 8 tile.
__device__ __forceinline__ void mma_and_popc(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(0), "r"(0), "r"(0), "r"(0));
}

__global__ void __launch_bounds__(kThreads)
hamming_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               int32_t* __restrict__ out, int n, int m, int64_t stride_a,
               int64_t stride_b) {
  __shared__ __align__(16) uint32_t sa[kTileN][kWords];
  __shared__ __align__(16) uint32_t sb[kTileM][kWords];
  __shared__ int pa[kTileN];
  __shared__ int pb[kTileM];
  __shared__ __align__(16) int32_t so[kThreads / 32][16][kWarpStride];

  a += blockIdx.z * stride_a;
  b += blockIdx.z * stride_b;
  out += blockIdx.z * static_cast<int64_t>(n) * m;
  const int row0 = blockIdx.y * kTileN;
  const int col0 = blockIdx.x * kTileM;
  const int tid = threadIdx.x;

  // two 16-byte halves per row: 128 for A, then 256 for B
  for (int e = tid; e < 2 * (kTileN + kTileM); e += kThreads) {
    const bool in_a = e < 2 * kTileN;
    const int f = in_a ? e : e - 2 * kTileN;
    const int r = f >> 1, h = 4 * (f & 1);
    const int gr = (in_a ? row0 : col0) + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr < (in_a ? n : m)) {
      v = *reinterpret_cast<const uint4*>((in_a ? a : b) +
                                          static_cast<int64_t>(gr) * kWords + h);
    }
    *reinterpret_cast<uint4*>(in_a ? &sa[r][h] : &sb[r][h]) = v;
  }
  __syncthreads();
  if (tid < kTileN + kTileM) {
    const uint32_t* row = tid < kTileN ? sa[tid] : sb[tid - kTileN];
    int p = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) p += __popc(row[w]);
    (tid < kTileN ? pa[tid] : pb[tid - kTileN]) = p;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // the fragments' group and thread
  const int wr = (warp & 3) * 16;          // the warp's 16 rows
  const int wc = (warp >> 2) * 64;         // and 64 columns
  int32_t (*sw)[kWarpStride] = so[warp];
  const uint32_t af[4] = {sa[wr + g][t], sa[wr + g + 8][t], sa[wr + g][t + 4],
                          sa[wr + g + 8][t + 4]};
  const int pa0 = pa[wr + g], pa1 = pa[wr + g + 8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + 2 * t;           // accumulator columns c, c + 1
    int d[4];
    mma_and_popc(d, af, sb[wc + j * 8 + g][t], sb[wc + j * 8 + g][t + 4]);
    const int pb0 = pb[wc + c], pb1 = pb[wc + c + 1];
    *reinterpret_cast<int2*>(&sw[g][c]) =
        make_int2(pa0 + pb0 - 2 * d[0], pa0 + pb1 - 2 * d[1]);
    *reinterpret_cast<int2*>(&sw[g + 8][c]) =
        make_int2(pa1 + pb0 - 2 * d[2], pa1 + pb1 - 2 * d[3]);
  }
  __syncwarp();

  const int gr0 = row0 + wr, gc0 = col0 + wc;
  if ((m & 3) == 0 && gc0 + 64 <= m) {
    const int q = lane & 15;               // 16-byte word of the row segment
    for (int r = lane >> 4; r < 16 && gr0 + r < n; r += 2) {
      *reinterpret_cast<int4*>(out + static_cast<int64_t>(gr0 + r) * m + gc0 +
                               4 * q) =
          *reinterpret_cast<const int4*>(&sw[r][4 * q]);
    }
  } else {
    for (int e = lane; e < 16 * 64; e += 32) {
      const int r = e >> 6, c = e & 63;
      if (gr0 + r < n && gc0 + c < m) {
        out[static_cast<int64_t>(gr0 + r) * m + gc0 + c] = sw[r][c];
      }
    }
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
    const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN,
                    batch);
    hamming_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<int32_t*>(out), n, m, stride_a, stride_b);
  }
  return static_cast<int>(cudaGetLastError());
}
