// The global BA's conjugate-gradient half-steps, for sm_90a: two entry
// points, two launches a CG iteration.
//
// Replaces airdos_tpu/solvers/global_ba.py:113 schur_matvec, :133 precond
// and :143 cg_body (XLA gathers, scatter-adds, einsums and the CG's
// vector algebra; no Pallas kernel), which the port ran as ~60 eager
// launches an iteration.  The plain versions are ops/ba_global.py
// schur_point_ref and schur_camera_ref.
//
// schur_point, a thread a point p: s = sum over p's edges i (the
// point-keyed walk's rows offsets[p]..offsets[p+1], in order, from 0) of
// y_i, y_i[l] = W_i[0][l] xm0 + W_i[1][l] xm1 + ... + W_i[5][l] xm5 (left
// to right) with xm = x[cam_i] * cam_free[cam_i]; z[l] = (Hi[l][0] s0 +
// Hi[l][1] s1) + Hi[l][2] s2 (raw: s itself).  A point has ~3 edges.
//
// schur_camera, a block a camera c: back = sum over c's edges i (the
// camera-keyed walk's rows, in order, from 0) of y_i, y_i[k] = (W_i[k][0]
// z0 + W_i[k][1] z1) + W_i[k][2] z2.  The block computes a chunk of
// kThreads rows' y at once (a thread a row) into shared memory; then
// thread k adds column k over the chunk in row order.  Raw: back is the
// output.  Else Ap = (Hcc_d xm - back) f + xm (1 - f), f = cam_free[c],
// xm = p[c] f, the camera's partial q_c = p0 Ap0 + ... + p5 Ap5 (left to
// right), and the last block to finish (a counter after a
// __threadfence; it leaves the counter at zero) runs the CG update:
//   pAp = fixed sum of q;  alpha = |pAp| > 1e-20 ? rz / pAp : 0;
//   x += alpha p;  r -= alpha Ap;  z = D^-1 r;  q_c = r_c . z_c;
//   rz' = fixed sum of q;  beta = |rz| > 1e-20 ? rz' / rz : 0;
//   p = z + beta p;  rz = rz'.
// The fixed sum: lane j of kThreads adds q[j], q[j + kThreads], ... from
// 0 in sequence, then a halving tree (ops/ba_global.py fixed_sum).
//
// Exact: every product, sum and quotient is an __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn, which nvcc does not contract into a multiply-add,
// in the plain versions' order (torch rounds each eager op alike; the
// plain segment sums are index_add_ in walk order, from 0).  So the
// outputs are bit-equal to the plain versions'.  No float atomics: two
// launches are bit-equal.
//
// What bounds it on an H100.  Bytes: a half-step reads its walk's copy of
// Wcp once, 72 B an edge (21.5 MB at the map scale's 298,380 edges, ~6.4
// us at 3.35 TB/s), and the walk's other-end index (4 B an edge); the
// rest (x, z, Hpp^-1, Hcc_d, D^-1) is ~4.4 MB at P 100,000, C 1000.  An
// iteration's bound is ~15 us.  Operations are few (36 an edge a half).
// The camera half's chain of dependent adds (~300 edges a camera) and the
// last block's update (one SM over C x 6 entries and their D^-1 rows) are
// latency, not bandwidth.
//
// The C entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // ops/ba_global.py LANES
constexpr int kPointThreads = 128;
constexpr float kGuard = 1e-20f;       // global_ba.py:174, :179

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

__global__ void __launch_bounds__(kPointThreads)
schur_point_kernel(const float* __restrict__ w, const int32_t* __restrict__ cam,
                   const int32_t* __restrict__ offsets,
                   const float* __restrict__ x,
                   const float* __restrict__ cam_free,
                   const float* __restrict__ hinv, int n_points, int raw,
                   float* __restrict__ out) {
  const int p = blockIdx.x * kPointThreads + threadIdx.x;
  if (p >= n_points) return;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  const int end = offsets[p + 1];
  for (int i = offsets[p]; i < end; ++i) {
    const int c = cam[i];
    const float f = cam_free[c];
    float xm[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) xm[k] = fmul(x[c * 6 + k], f);
    const float* wi = w + static_cast<int64_t>(i) * 18;
    float y[3];
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      float acc = fmul(wi[l], xm[0]);
#pragma unroll
      for (int k = 1; k < 6; ++k) acc = fadd(acc, fmul(wi[k * 3 + l], xm[k]));
      y[l] = acc;
    }
    s0 = fadd(s0, y[0]);
    s1 = fadd(s1, y[1]);
    s2 = fadd(s2, y[2]);
  }
  float* o = out + static_cast<int64_t>(p) * 3;
  if (raw) {
    o[0] = s0;
    o[1] = s1;
    o[2] = s2;
    return;
  }
  const float* h = hinv + static_cast<int64_t>(p) * 9;
#pragma unroll
  for (int l = 0; l < 3; ++l)
    o[l] = fadd(fadd(fmul(h[l * 3], s0), fmul(h[l * 3 + 1], s1)),
                fmul(h[l * 3 + 2], s2));
}

// the fixed sum of q[0..n) (written by other blocks: read past L1) over
// the block's kThreads lanes; every thread gets the sum
__device__ float fixed_sum(const float* q, int n, float* red) {
  const int t = threadIdx.x;
  float s = 0.0f;
  for (int c = t; c < n; c += kThreads) s = fadd(s, __ldcg(q + c));
  red[t] = s;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (t < off) red[t] = fadd(red[t], red[t + off]);
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();  // red is free again
  return total;
}

// y = M v for a 6x6 row-major M, each row left to right
__device__ __forceinline__ void matvec6(const float* m, const float* v,
                                        float* y) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float acc = fmul(m[k * 6], v[0]);
#pragma unroll
    for (int l = 1; l < 6; ++l) acc = fadd(acc, fmul(m[k * 6 + l], v[l]));
    y[k] = acc;
  }
}

struct CameraArgs {
  const float* w;          // [E, 18] the camera walk's rows
  const int32_t* pt;       // [E] each row's point
  const int32_t* offsets;  // [C + 1]
  const float* z;          // [P, 3]
  const float* hcc_d;      // [C, 36]
  const float* d_inv;      // [C, 36]
  const float* cam_free;   // [C]
  float* x;                // [C, 6]
  float* r;                // [C, 6]
  float* p;                // [C, 6]
  float* rz;               // [1]
  float* ap;               // [C, 6] Ap, then z = D^-1 r (raw: back)
  float* part;             // [C] the cameras' partial dot products
  unsigned* count;         // [1] blocks finished
  int n_cams;
  int raw;
};

// the CG update over every camera, by the last block
__device__ void cg_update(const CameraArgs& a, float* red) {
  __shared__ float s_alpha, s_beta;
  const int t = threadIdx.x;
  const int C = a.n_cams;
  const float rz = __ldcg(a.rz);
  const float pap = fixed_sum(a.part, C, red);
  if (t == 0) s_alpha = fabsf(pap) > kGuard ? __fdiv_rn(rz, pap) : 0.0f;
  __syncthreads();
  const float alpha = s_alpha;
  for (int c = t; c < C; c += kThreads) {
    float rv[6], zv[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float pk = __ldcg(a.p + c * 6 + k);
      a.x[c * 6 + k] = fadd(__ldcg(a.x + c * 6 + k), fmul(alpha, pk));
      rv[k] = fsub(__ldcg(a.r + c * 6 + k), fmul(alpha, __ldcg(a.ap + c * 6 + k)));
      a.r[c * 6 + k] = rv[k];
    }
    float dinv[36];
#pragma unroll
    for (int j = 0; j < 36; ++j) dinv[j] = a.d_inv[c * 36 + j];
    matvec6(dinv, rv, zv);
    float q = fmul(rv[0], zv[0]);
#pragma unroll
    for (int k = 1; k < 6; ++k) q = fadd(q, fmul(rv[k], zv[k]));
#pragma unroll
    for (int k = 0; k < 6; ++k) a.ap[c * 6 + k] = zv[k];
    a.part[c] = q;
  }
  __syncthreads();  // every q and z is written (and visible to the block)
  const float rz_new = fixed_sum(a.part, C, red);
  if (t == 0) s_beta = fabsf(rz) > kGuard ? __fdiv_rn(rz_new, rz) : 0.0f;
  __syncthreads();
  const float beta = s_beta;
  for (int c = t; c < C; c += kThreads) {
#pragma unroll
    for (int k = 0; k < 6; ++k)
      a.p[c * 6 + k] = fadd(__ldcg(a.ap + c * 6 + k),
                            fmul(beta, __ldcg(a.p + c * 6 + k)));
  }
  if (t == 0) {
    a.rz[0] = rz_new;
    a.count[0] = 0u;  // for the next launch
  }
}

__global__ void __launch_bounds__(kThreads)
schur_camera_kernel(const CameraArgs a) {
  __shared__ float ys[kThreads * 6];
  __shared__ float red[kThreads];
  __shared__ float qk[6];
  __shared__ bool last;
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int begin = a.offsets[c];
  const int end = a.offsets[c + 1];
  float acc = 0.0f;  // thread k < 6: back[k]
  for (int r0 = begin; r0 < end; r0 += kThreads) {
    const int rows = min(kThreads, end - r0);
    if (t < rows) {
      const int i = r0 + t;
      const float* z = a.z + static_cast<int64_t>(a.pt[i]) * 3;
      const float z0 = z[0], z1 = z[1], z2 = z[2];
      const float* wi = a.w + static_cast<int64_t>(i) * 18;
#pragma unroll
      for (int k = 0; k < 6; ++k)
        ys[t * 6 + k] = fadd(fadd(fmul(wi[k * 3], z0), fmul(wi[k * 3 + 1], z1)),
                             fmul(wi[k * 3 + 2], z2));
    }
    __syncthreads();
    if (t < 6) {
      // in row order, one add at a time: float addition is not associative
#pragma unroll 8
      for (int j = 0; j < rows; ++j) acc = fadd(acc, ys[j * 6 + t]);
    }
    __syncthreads();  // the chunk is read before the next one lands
  }
  if (a.raw) {
    if (t < 6) a.ap[c * 6 + t] = acc;
    return;
  }
  if (t < 6) {
    const float f = a.cam_free[c];
    const float nf = 1.0f - f;
    float xm[6];
#pragma unroll
    for (int l = 0; l < 6; ++l) xm[l] = fmul(a.p[c * 6 + l], f);
    const float* h = a.hcc_d + c * 36 + t * 6;
    float hx = fmul(h[0], xm[0]);
#pragma unroll
    for (int l = 1; l < 6; ++l) hx = fadd(hx, fmul(h[l], xm[l]));
    const float ap = fadd(fmul(fsub(hx, acc), f), fmul(xm[t], nf));
    a.ap[c * 6 + t] = ap;
    qk[t] = fmul(a.p[c * 6 + t], ap);
  }
  __syncthreads();
  if (t == 0) {
    float q = qk[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) q = fadd(q, qk[k]);
    a.part[c] = q;
    __threadfence();  // Ap and q are visible before the count says so
    last = atomicAdd(a.count, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  cg_update(a, red);
}

}  // namespace

// w: [E, 18] float32 (the point walk's rows), cam: [E] int32, offsets:
// [P + 1] int32, x: [C, 6], cam_free: [C], hinv: [P, 9] float32; out:
// [P, 3] float32 (z, or with raw the sums).
extern "C" int airdos_schur_point(const void* w, const void* cam,
                                  const void* offsets, const void* x,
                                  const void* cam_free, const void* hinv,
                                  int n_points, int raw, void* out,
                                  void* stream) {
  if (n_points <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (n_points + kPointThreads - 1) / kPointThreads;
  schur_point_kernel<<<blocks, kPointThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const int32_t*>(cam),
      static_cast<const int32_t*>(offsets), static_cast<const float*>(x),
      static_cast<const float*>(cam_free), static_cast<const float*>(hinv),
      n_points, raw, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// w: [E, 18] float32 (the camera walk's rows), pt: [E] int32, offsets:
// [C + 1] int32, z: [P, 3], hcc_d, d_inv: [C, 36], cam_free: [C]; the CG
// state x, r, p: [C, 6], rz: [1]; ap: [C, 6] scratch (raw: the output
// back), part: [C] scratch; count: [1] uint32, zero before the launch
// (the last block leaves it so).
extern "C" int airdos_schur_camera(
    const void* w, const void* pt, const void* offsets, const void* z,
    const void* hcc_d, const void* d_inv, const void* cam_free, void* x,
    void* r, void* p, void* rz, void* ap, void* part, int n_cams, int raw,
    void* count, void* stream) {
  if (n_cams <= 0) return static_cast<int>(cudaGetLastError());
  CameraArgs a;
  a.w = static_cast<const float*>(w);
  a.pt = static_cast<const int32_t*>(pt);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.z = static_cast<const float*>(z);
  a.hcc_d = static_cast<const float*>(hcc_d);
  a.d_inv = static_cast<const float*>(d_inv);
  a.cam_free = static_cast<const float*>(cam_free);
  a.x = static_cast<float*>(x);
  a.r = static_cast<float*>(r);
  a.p = static_cast<float*>(p);
  a.rz = static_cast<float*>(rz);
  a.ap = static_cast<float*>(ap);
  a.part = static_cast<float*>(part);
  a.count = static_cast<unsigned*>(count);
  a.n_cams = n_cams;
  a.raw = raw;
  schur_camera_kernel<<<n_cams, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
