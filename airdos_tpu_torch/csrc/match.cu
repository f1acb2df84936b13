// The tracking matchers' gate, best / second-best reduction and
// uniqueness resolution, for sm_90a: two kernels, match_rows and
// match_resolve.
//
// Replaces the epilogues around the Pallas kernel
// airdos_tpu/ops/pallas_kernels.py:36 hamming_matrix_pallas (the call at
// :43, dispatched by :59 hamming_matrix_auto) in the four matchers of the
// tracking path: matching/stereo.py:88 stereo_match (gate, best, mutual,
// far-u second), matching/projection.py:81 match_last_frame and :130
// match_local_points (window, octave band, right-u gate; best, second and
// level ratio; :61 _rotation_consistency and :41 _resolve_unique) and
// matching/bow_match.py:31 match_by_bow (node gate, best, second,
// rotation, uniqueness).  On the TPU each is the Pallas tile kernel writing
// the dense [P, N] distance matrix plus XLA fusions of the gate, argmins
// and scatter-mins.  Here the distances of the pairs that pass the gate
// are computed where they are reduced, and the [P, N] matrix never
// reaches device memory.  The port's plain versions are
// ops/match_kernels.py match_rows_ref and match_resolve_ref.
//
// match_rows, one launch a matcher call.  For row p (a point or a left
// keypoint) and column j (a feature or a right keypoint) the gate of the
// mode holds or not:
//   motion, local (projection): |x_j - u_p| < r_p and |y_j - v_p| < r_p,
//     key_j in [key_p + lo, key_p + hi] (either end may be open), and
//     |ur_p - w_j| < r_p where w_j > 0;
//   stereo: |v_p - y_j| <= w_j (the row band 2 scale[oct_j]),
//     |key_p - key_j| <= 1, and 0 <= u_p - x_j <= max_d;
//   bow: key_p == key_j, both >= 0;
// and in every mode row p and column j are valid (a column not taken).
// D[p, j] = popc(desc_p ^ desc_j) over the 8 words where the gate holds,
// else BIG = 1024 (above any distance, 256 at most).  Per row:
//   best = argmin_j D[p, j] and its distance (ties to the lower index;
//     a row with no gated pair gives index 0 and BIG, as argmin does);
//   second = argmin over j != best (motion, local, bow), or over the
//     columns with |x_j - x_best| > 1.5 (stereo), BIG and index 0 where
//     none is left;
//   has = dist <= th and the mode's ratio test: local rejects where the
//     two share an octave, dist > ratio * second and second < BIG;
//     stereo keeps dist < ratio * min(second, 256); bow keeps
//     dist < ratio * second; motion has none.  Stereo also needs the
//     mutual check: the best row of column best is p.
// Stereo writes each column's argmin row too (index 0 for a column with
// no gated pair).
//
// Semantics and exactness.  A (distance, index) pair is one 32-bit key,
// distance << 21 | index: the minimum key is the minimum distance with
// ties to the lower index, whatever order the keys are met in, so the
// warp's __reduce_min_sync and the column minima's atomics are
// deterministic.  The column keys are kept complemented (atomicMax of
// ~key) so that a zeroed scratch (cudaMemsetAsync) means "no gated pair".
// Every gate comparison is one float32 subtraction (__fsub_rn, no
// contraction), fabsf and compare on the operands the plain version
// uses, the ratio a float32 product (__fmul_rn) of the ratio rounded to
// float32 (torch's rounding of a Python scalar) and the distance, so
// every output is the plain version's, bit for bit.
//
// Design.  A block of 8 warps stages the column table (key int64, x, y,
// w float32, the valid-and-not-taken flag: 21 bytes a column, 32 kB at
// 1536 columns) in shared memory once; each warp then takes a row: its
// lanes stride over the columns, evaluate the gate from shared memory and
// read the column's descriptor (two 16-byte loads, from L2) and popcount
// only for the gated pairs, keeping their two smallest keys; two
// __reduce_min_sync give best and second.  Stereo's second needs best's
// x first, so it takes a second pass over the row.  Stereo's column
// minima are global atomics of the gated pairs; the last block to finish
// (a counter after a __threadfence) decodes them and applies the mutual
// check, so the matcher stays one launch.
//
// What bounds it on an H100.  Bytes: both descriptor sets and the row
// and column vectors read once (32 + ~21 bytes a row or column), the
// outputs (25 bytes a row) written once: ~0.1 MB at 2048 x 1536, 0.03
// us at 3.35 TB/s.  Operations: the gate at every pair (~10 float32 or
// integer operations) and a 256-bit XOR-popcount at the gated pairs
// only: ~3e7 operations at 2048 x 1536, ~0.5 us at the float32 rate of
// 67 TFLOP/s.  So the gate's scan bounds it, and the launch and the
// staging round trip are of the same order.  Later work: a grid of cells
// (ORB-SLAM's GetFeaturesInArea) so that a row scans only its window's
// columns, and the projection prelude folded in.
//
// match_resolve, one block a call: the 30-bin rotation histogram of the
// rows that have a match (bin = rint(((a_ref - a_cur) mod 360) *
// float32(30 / 360)), 30 -> 0, clamped to 0..29), its three largest bins
// (ties to the lower bin) with the 0.1 * max cut, and the uniqueness
// resolution: each column keeps the claiming row of least distance, ties
// to the lower row, through one shared atomicMin of a 64-bit key
// (distance << 32 | row; a row whose distance exceeds BIG never wins, as
// in the plain version).  Integer atomics in shared memory are
// deterministic.  Bytes and operations are a few per row: the launch
// bounds it.
//
// The C entry points launch on the caller's stream, allocate nothing,
// do not synchronise, and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

// The parameter blocks stand outside the unnamed namespace, so that the C
// entry points that take them keep external linkage.

// a strided vector (element stride), null where the mode reads none
struct Strided {
  const void* p;
  long long s;
};

// the layout of ops/match_kernels.py _RowsParams
struct RowsParams {
  long long mode, n_rows, n_cols;
  const uint4* row_desc;
  const uint4* col_desc;
  Strided row_x, row_y, row_ur, row_r, row_key, row_ok;
  Strided col_x, col_y, col_w, col_key, col_ok, col_taken;
  long long band_lo, band_hi, band_open, th;
  long long* idx;          // [2P + N]: best, second, the column argmin
  int* dist;               // [2P]: best, second
  unsigned char* has;      // [P]
  unsigned* scratch;       // stereo: [N] complemented column keys, counter
  float ratio, max_d;
};

// the layout of ops/match_kernels.py _ResolveParams
struct ResolveParams {
  long long n_rows, n_cols, rotation;
  const long long* best;
  const int* dist;
  const unsigned char* has;
  Strided ang_ref, ang_tab;
  long long* out;          // [P + N + 1]: feat_idx, point_of_feat, n
  float bin_scale;
};

namespace {

constexpr int kMotion = 0;
constexpr int kLocal = 1;
constexpr int kStereo = 2;
constexpr int kBow = 3;

constexpr unsigned kBig = 1u << 10;
constexpr int kIndexBits = 21;
constexpr unsigned kIndexMask = (1u << kIndexBits) - 1;
constexpr unsigned kNone = kBig << kIndexBits;   // (BIG, index 0)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;
constexpr int kBins = 30;
constexpr int kResolveThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T at(const Strided& v, long long i) {
  return static_cast<const T*>(v.p)[i * v.s];
}

__device__ __forceinline__ unsigned hamming(const uint4& a0, const uint4& a1,
                                            const uint4* __restrict__ b,
                                            int j) {
  const uint4 b0 = __ldg(b + 2 * j);
  const uint4 b1 = __ldg(b + 2 * j + 1);
  return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
         __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
         __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// the staged column table
struct Cols {
  const long long* key;
  const float* x;
  const float* y;
  const float* w;
  const unsigned char* ok;
};

// one row's gate values
struct Row {
  float x, y, ur, r;
  long long key;
};

__device__ __forceinline__ bool gate(const RowsParams& q, int mode,
                                     const Row& a, const Cols& c, int j) {
  if (!c.ok[j]) return false;
  const long long ck = c.key[j];
  if (mode == kBow) return ck == a.key && a.key >= 0 && ck >= 0;
  const float cx = c.x[j], cy = c.y[j], cw = c.w[j];
  if (mode == kStereo) {
    if (!(fabsf(__fsub_rn(a.y, cy)) <= cw)) return false;
    const long long dk = a.key - ck;
    if (dk > 1 || dk < -1) return false;
    const float disp = __fsub_rn(a.x, cx);
    return disp >= 0.f && disp <= q.max_d;
  }
  if (!(fabsf(__fsub_rn(cx, a.x)) < a.r && fabsf(__fsub_rn(cy, a.y)) < a.r))
    return false;
  if (!(q.band_open & 1) && ck < a.key + q.band_lo) return false;
  if (!(q.band_open & 2) && ck > a.key + q.band_hi) return false;
  return !(cw > 0.f) || fabsf(__fsub_rn(a.ur, cw)) < a.r;
}

__device__ __forceinline__ unsigned column_argmin(unsigned stored) {
  return stored == 0 ? 0u : (~stored & kIndexMask);
}

__global__ void __launch_bounds__(kThreads)
match_rows_kernel(const RowsParams q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int mode = static_cast<int>(q.mode);
  const long long P = q.n_rows;
  const int N = static_cast<int>(q.n_cols);
  const bool geo = mode != kBow;
  long long* skey = reinterpret_cast<long long*>(smem);
  float* sx = reinterpret_cast<float*>(skey + N);
  float* sy = sx + N;
  float* sw = sy + N;
  unsigned char* sok = reinterpret_cast<unsigned char*>(sw + N);
  for (int j = threadIdx.x; j < N; j += kThreads) {
    skey[j] = at<long long>(q.col_key, j);
    bool ok = at<unsigned char>(q.col_ok, j) != 0;
    if (q.col_taken.p != nullptr)
      ok = ok && at<unsigned char>(q.col_taken, j) == 0;
    sok[j] = ok;
    if (geo) {
      sx[j] = at<float>(q.col_x, j);
      sy[j] = at<float>(q.col_y, j);
      sw[j] = at<float>(q.col_w, j);
    }
  }
  __syncthreads();
  const Cols cols{skey, sx, sy, sw, sok};

  const int lane = threadIdx.x & 31;
  for (long long p = static_cast<long long>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
       p < P; p += static_cast<long long>(gridDim.x) * kWarps) {
    const bool row_ok = at<unsigned char>(q.row_ok, p) != 0;
    Row a{0.f, 0.f, 0.f, 0.f, at<long long>(q.row_key, p)};
    if (geo) {
      a.x = at<float>(q.row_x, p);
      a.y = at<float>(q.row_y, p);
    }
    if (mode == kMotion || mode == kLocal) {
      a.ur = at<float>(q.row_ur, p);
      a.r = at<float>(q.row_r, p);
    }
    const uint4 a0 = __ldg(q.row_desc + 2 * p);
    const uint4 a1 = __ldg(q.row_desc + 2 * p + 1);
    unsigned k1 = kNone, k2 = kNone;
    if (row_ok) {
      for (int j = lane; j < N; j += 32) {
        if (!gate(q, mode, a, cols, j)) continue;
        const unsigned d = hamming(a0, a1, q.col_desc, j);
        const unsigned key = d << kIndexBits | j;
        if (key < k1) {
          k2 = k1;
          k1 = key;
        } else if (key < k2) {
          k2 = key;
        }
        if (mode == kStereo)
          atomicMax(q.scratch + j,
                    ~(d << kIndexBits | static_cast<unsigned>(p)));
      }
    }
    const unsigned best = __reduce_min_sync(kFull, k1);
    unsigned cand = k1 == best ? k2 : k1;
    if (mode == kStereo) {
      cand = kNone;
      if (row_ok) {
        const float xb = sx[best & kIndexMask];
        for (int j = lane; j < N; j += 32) {
          if (!gate(q, mode, a, cols, j) ||
              !(fabsf(__fsub_rn(sx[j], xb)) > 1.5f))
            continue;
          const unsigned d = hamming(a0, a1, q.col_desc, j);
          cand = min(cand, d << kIndexBits | j);
        }
      }
    }
    const unsigned second = __reduce_min_sync(kFull, cand);
    if (lane == 0) {
      const unsigned bd = best >> kIndexBits, bi = best & kIndexMask;
      const unsigned sd = second >> kIndexBits, si = second & kIndexMask;
      q.idx[p] = bi;
      q.idx[P + p] = si;
      q.dist[p] = static_cast<int>(bd);
      q.dist[P + p] = static_cast<int>(sd);
      const float fb = __uint2float_rn(bd);
      bool h = static_cast<long long>(bd) <= q.th;
      if (mode == kLocal)
        h = h && !(skey[bi] == skey[si] &&
                   fb > __fmul_rn(q.ratio, __uint2float_rn(sd)) && sd < kBig);
      else if (mode == kStereo)
        h = h && fb < __fmul_rn(q.ratio, __uint2float_rn(min(sd, 256u)));
      else if (mode == kBow)
        h = h && fb < __fmul_rn(q.ratio, __uint2float_rn(sd));
      q.has[p] = h;
    }
  }
  if (mode != kStereo) return;

  // the last block to finish decodes the column minima and applies the
  // mutual check to every row
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(q.scratch + N, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int j = threadIdx.x; j < N; j += kThreads)
    q.idx[2 * P + j] = column_argmin(__ldcg(q.scratch + j));
  for (long long p = threadIdx.x; p < P; p += kThreads) {
    const long long b = __ldcg(q.idx + p);
    const bool mutual = column_argmin(__ldcg(q.scratch + b)) == p;
    q.has[p] = __ldcg(q.has + p) != 0 && mutual;
  }
}

// the rotation bin of row p (its best column's angle against the row's)
__device__ __forceinline__ int rotation_bin(const ResolveParams& q,
                                            long long p, long long b) {
  float rot = __fsub_rn(at<float>(q.ang_ref, p), at<float>(q.ang_tab, b));
  if (rot < 0.f) rot = __fadd_rn(rot, 360.f);
  const float binf = rintf(__fmul_rn(rot, q.bin_scale));
  int bin = binf == static_cast<float>(kBins) ? 0 : static_cast<int>(binf);
  return min(max(bin, 0), kBins - 1);
}

__global__ void __launch_bounds__(kResolveThreads)
match_resolve_kernel(const ResolveParams q) {
  extern __shared__ long long seg[];          // [N] keys
  __shared__ int hist[kBins];
  __shared__ bool keep[kBins];
  __shared__ unsigned long long n_final;
  const long long P = q.n_rows;
  const long long N = q.n_cols;
  // above every (distance <= BIG, row) key: a row farther than BIG never
  // wins, as under the plain version's segment minimum starting at BIG
  const long long unset = static_cast<long long>(kBig) << 32 | 0xffffffffLL;
  for (long long f = threadIdx.x; f < N; f += kResolveThreads) seg[f] = unset;
  if (threadIdx.x < kBins) {
    hist[threadIdx.x] = 0;
    keep[threadIdx.x] = true;
  }
  if (threadIdx.x == 0) n_final = 0;
  __syncthreads();

  if (q.rotation) {
    for (long long p = threadIdx.x; p < P; p += kResolveThreads)
      if (q.has[p]) atomicAdd(hist + rotation_bin(q, p, q.best[p]), 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      int top[3], val[3];
      bool taken[kBins];
      for (int b = 0; b < kBins; ++b) taken[b] = false;
      for (int k = 0; k < 3; ++k) {       // the largest, ties to the lower
        int pick = 0, best = -1;
        for (int b = 0; b < kBins; ++b)
          if (!taken[b] && hist[b] > best) {
            best = hist[b];
            pick = b;
          }
        taken[pick] = true;
        top[k] = pick;
        val[k] = best;
      }
      for (int b = 0; b < kBins; ++b) keep[b] = false;
      const float cut = __fmul_rn(0.1f, __int2float_rn(val[0]));
      for (int k = 0; k < 3; ++k) keep[top[k]] = __int2float_rn(val[k]) >= cut;
    }
    __syncthreads();
  }

  for (long long p = threadIdx.x; p < P; p += kResolveThreads) {
    const long long b = q.best[p];
    if (!q.has[p] || b < 0 || b >= N) continue;
    if (q.rotation && !keep[rotation_bin(q, p, b)]) continue;
    atomicMin(seg + b, static_cast<long long>(q.dist[p]) << 32 | p);
  }
  __syncthreads();
  for (long long p = threadIdx.x; p < P; p += kResolveThreads) {
    const long long b = q.best[p];
    bool won = q.has[p] && b >= 0 && b < N &&
               (!q.rotation || keep[rotation_bin(q, p, b)]);
    won = won && seg[b] == (static_cast<long long>(q.dist[p]) << 32 | p);
    q.out[p] = won ? b : -1;
    if (won) atomicAdd(&n_final, 1ull);
  }
  for (long long f = threadIdx.x; f < N; f += kResolveThreads)
    q.out[P + f] = seg[f] == unset ? -1 : (seg[f] & 0xffffffffLL);
  __syncthreads();
  if (threadIdx.x == 0) q.out[P + N] = static_cast<long long>(n_final);
}

int dynamic_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace

extern "C" int airdos_match_rows(const RowsParams* params, void* stream) {
  const RowsParams q = *params;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q.n_rows <= 0 || q.n_cols <= 0)
    return static_cast<int>(cudaGetLastError());
  if (q.mode == kStereo) {
    const cudaError_t err = cudaMemsetAsync(
        q.scratch, 0, (q.n_cols + 1) * sizeof(unsigned), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = static_cast<size_t>(q.n_cols) * 21;
  const int err = dynamic_smem(
      reinterpret_cast<const void*>(match_rows_kernel), smem);
  if (err != 0) return err;
  long long blocks = (q.n_rows + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  match_rows_kernel<<<static_cast<int>(blocks), kThreads, smem, s>>>(q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int airdos_match_resolve(const ResolveParams* params,
                                    void* stream) {
  const ResolveParams q = *params;
  const size_t smem = static_cast<size_t>(q.n_cols) * sizeof(long long);
  const int err = dynamic_smem(
      reinterpret_cast<const void*>(match_resolve_kernel), smem);
  if (err != 0) return err;
  match_resolve_kernel<<<1, kResolveThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}
