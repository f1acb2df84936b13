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
// Hi[l][1] s1) + Hi[l][2] s2 (raw: s itself).  A point has ~3 edges.  The
// block's points own one contiguous span of the walk: the block copies it
// (Wcp's rows and their cameras) into shared memory with 16-byte async
// copies, `rows` at a time, the start rounded down to 16 bytes (the block
// and its buffer sized by the entry point from P and E, so that the map
// scale's blocks fit the card at once and a small P still spreads over
// its SMs); each thread then gathers its rows' x (8-byte loads) and
// cam_free, four rows at once, and adds them in walk order.  Hpp^-1 is
// loaded first.
//
// schur_camera, a warp a camera c: back = sum over c's edges i (the
// camera-keyed walk's rows, in order, from 0) of y_i, y_i[k] = (W_i[k][0]
// z0 + W_i[k][1] z1) + W_i[k][2] z2.  The warp copies the segment's Wcp
// rows and their points into its share of the block's shared memory (the
// warps that have a camera split buffers sized from E / C, at most ~320
// rows a warp when eight share them) with async copies, then gathers the
// rows' z into it the same way while Wcp's rows land; lane j computes the
// y of rows j, j + 32, ... over their rows' first six floats, and lane
// k < 6 then adds column k over the rows in walk order (kChain loads
// issued ahead of their adds): the order of airdos_tpu's scatter-add.  (32
// lanes and a halving tree, tried, moved the corridor's global BA from
// airdos_tpu by 9.1e-4 in float32, and in float64 rounded once by 3.7e-4
// in t and 1.4e-3 m in points, against limits of 1e-4 and 1e-3: an LM
// step decided the other way.  The whole CG in float64 moved it 2.65e-4
// in either order: the float32 Gauss-Newton pieces' noise, which any
// other order reseeds.  Only airdos_tpu's own order stays within;
// tests/torch_camera_order.py.)
// The camera's p, Hcc_d row, cam_free and (for the update) x, r and D^-1
// row are loaded before the walk, lane k < 6 holding row k.  Ap = (Hcc_d
// xm - back) f + xm (1 - f), f = cam_free[c], xm = p[c] f, and the
// camera's partial q_c = p0 Ap0 + ... + p5 Ap5 (left to right).  Raw:
// back is the output, and every block returns after its cameras' sums,
// before the first barrier.  The launch is cooperative (a grid that fits
// the card at once, warps striding over the cameras); after a grid
// barrier every block runs the CG update for its own cameras:
//   pAp = fixed sum of q;  alpha = |pAp| > 1e-20 ? rz / pAp : 0;
//   x += alpha p;  r -= alpha Ap;  z = D^-1 r;  q'_c = r_c . z_c;
// and after a second barrier
//   rz' = fixed sum of q';  beta = |rz| > 1e-20 ? rz' / rz : 0;
//   p = z + beta p;  rz = rz' (block 0).
// Every block sums q (part[0]) and q' (part[1]) itself in one fixed order,
// so all get the same bits: lane j of kThreads adds q[j], q[j +
// kThreads], ... from 0 in sequence, then a halving tree
// (ops/ba_global.py fixed_sum).  A camera's update reads only what its own
// warp loaded or wrote.
//
// Exact: every product, sum and quotient is an __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn, which nvcc does not contract into a multiply-add,
// in the plain versions' order (torch rounds each eager op alike).  So the
// outputs are bit-equal to the plain versions'.  No float atomics and no
// order that depends on scheduling: two launches are bit-equal.
//
// What bounds it on an H100.  Bytes: a half-step reads its walk's copy of
// Wcp once, 72 B an edge (21.5 MB at the map scale's 298,380 edges, ~6.4
// us at 3.35 TB/s), and the walk's other-end index (4 B an edge); the
// rest (x, z, Hpp^-1, Hcc_d, D^-1) is ~4.4 MB at P 100,000, C 1000.  An
// iteration's bound is ~15 us.  Operations are few (36 an edge a half).
// The rest is latency: a camera's chain of adds (~300 at the map scale,
// ~630 at pillar, ~4 cycles each from shared memory), about three
// dependent round trips to memory (offsets, then the rows and points,
// then z), two grid barriers and the update's two fixed sums read from
// L2.
//
// The C entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return the launch's error.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;          // a camera block; ops/ba_global.py LANES
constexpr int kWarps = kThreads / 32;
constexpr int kCamSmem = 225 * 1024;   // a camera block's buffers at most, bytes
constexpr int kCamRowFloats = 22;      // a staged row: Wcp 18, its point, z 3
constexpr int kChain = 32;             // the chain's loads issued at once
constexpr int kPointThreads = 128;     // a point block's most threads
constexpr int kPointRowsMax = 560;     // its staged rows: < 48 KB of buffers
constexpr float kGuard = 1e-20f;       // global_ba.py:174, :179
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void copy8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
// close a group of copies; wait for all but the newest group
__device__ __forceinline__ void copies_but_last_done() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;\n" ::: "memory");
}

// Start copying the walk's rows [s, s + n) of w (18 floats a row) into buf,
// thread `t` of `nt`: 16-byte copies from the start rounded down to 16
// bytes, 8 at the end of an odd row count.  Returns row s's offset in buf
// (0 or 2 floats).
__device__ __forceinline__ int stage_rows(const float* __restrict__ w, int s,
                                          int n, float* buf, int t, int nt) {
  const int64_t u0 = 9LL * s, u1 = 9LL * (s + n);   // in float2 units
  const int64_t a0 = u0 & ~1LL;
  for (int64_t k = a0 + 2 * t; k < u1; k += 2 * nt) {
    if (k + 1 < u1)
      copy16(buf + 2 * (k - a0), w + 2 * k);
    else
      copy8(buf + 2 * (k - a0), w + 2 * k);
  }
  return static_cast<int>(2 * (u0 - a0));
}

__global__ void __launch_bounds__(kPointThreads)
schur_point_kernel(const float* __restrict__ w, const int32_t* __restrict__ cam,
                   const int32_t* __restrict__ offsets,
                   const float* __restrict__ x,
                   const float* __restrict__ cam_free,
                   const float* __restrict__ hinv, int n_points, int rows,
                   int raw, float* __restrict__ out) {
  extern __shared__ __align__(16) float sw[];        // rows * 18 + 4 floats
  int32_t* sc = reinterpret_cast<int32_t*>(sw + rows * 18 + 4);  // rows
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int p0 = blockIdx.x * nt;
  const int p = p0 + t;
  const bool live = p < n_points;
  const int span0 = offsets[p0];
  const int span1 = offsets[min(p0 + nt, n_points)];
  const int begin = live ? offsets[p] : 0;
  const int end = live ? offsets[p + 1] : 0;
  float h[9];
  if (live && !raw) {
    const float* hp = hinv + static_cast<int64_t>(p) * 9;
#pragma unroll
    for (int j = 0; j < 9; ++j) h[j] = hp[j];
  }
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int s = span0; s < span1; s += rows) {
    const int n = min(rows, span1 - s);
    const int shift = stage_rows(w, s, n, sw, t, nt);
    for (int i = t; i < n; i += nt) copy4(sc + i, cam + s + i);
    copies_done();
    __syncthreads();
    const int i1 = min(end, s + n);
    for (int i = max(begin, s); i < i1; i += 4) {
      // four rows' gathers first, then their products in walk order
      float xm[4][6];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i + j < i1) {
          const int c = sc[i + j - s];
          const float f = cam_free[c];
          const float2* xc = reinterpret_cast<const float2*>(x + c * 6);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float2 v = xc[k];
            xm[j][2 * k] = fmul(v.x, f);
            xm[j][2 * k + 1] = fmul(v.y, f);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i + j < i1) {
          const float* wi = sw + shift + 18 * (i + j - s);
          float y[3];
#pragma unroll
          for (int l = 0; l < 3; ++l) {
            float acc = fmul(wi[l], xm[j][0]);
#pragma unroll
            for (int k = 1; k < 6; ++k) acc = fadd(acc, fmul(wi[k * 3 + l], xm[j][k]));
            y[l] = acc;
          }
          s0 = fadd(s0, y[0]);
          s1 = fadd(s1, y[1]);
          s2 = fadd(s2, y[2]);
        }
      }
    }
    __syncthreads();  // the buffers are read before the next rows land
  }
  if (!live) return;
  float* o = out + static_cast<int64_t>(p) * 3;
  if (raw) {
    o[0] = s0;
    o[1] = s1;
    o[2] = s2;
    return;
  }
#pragma unroll
  for (int l = 0; l < 3; ++l)
    o[l] = fadd(fadd(fmul(h[l * 3], s0), fmul(h[l * 3 + 1], s1)),
                fmul(h[l * 3 + 2], s2));
}

// the fixed sum of q[0..n) (written by other blocks: read past L1) over
// the block's kThreads lanes; every thread gets the sum
__device__ float fixed_sum(const float* q, int n, float* red) {
  const int t = threadIdx.x;
  float s = 0.0f;           // q[t], q[t + kThreads], ... in sequence: 8
  for (int b = 0; b < n; b += 8 * kThreads) {   // loads issued at once (a
    float v[8];             // zero added past n leaves s as it is: s is
#pragma unroll              // never -0)
    for (int u = 0; u < 8; ++u) {
      const int c = b + t + u * kThreads;
      v[u] = c < n ? __ldcg(q + c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) s = fadd(s, v[u]);
  }
  red[t] = s;
  __syncthreads();
  for (int off = kThreads / 2; off >= 32; off >>= 1) {
    if (t < off) red[t] = fadd(red[t], red[t + off]);
    __syncthreads();
  }
  if (t < 32) {            // the tree's last five levels in warp 0
    float v = red[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = fadd(v, __shfl_down_sync(kAll, v, off));
    if (t == 0) red[0] = v;
  }
  __syncthreads();
  const float total = red[0];
  __syncthreads();  // red is free again
  return total;
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
  float* part;             // [2, C] the cameras' p.Ap and r.z
  int n_cams;
  int raw;                 // write back into ap and stop
  int smem_floats;         // the block's buffers
};

// Lane k (< 6; higher lanes copy lane 5) of a camera's warp: what the
// update needs of the camera, loaded before its walk.
struct Cam {
  int c;
  float p, x, r, ap, z;
  float d[6];              // row k of D^-1
};

// back[k] of camera c on every lane of its warp: the walk's rows summed
// in walk order, through the warp's buffer of `rows` rows.
__device__ __forceinline__ void camera_sums(const CameraArgs& a, int c,
                                            float* buf, int rows, int lane,
                                            float back[6]) {
  const int begin = a.offsets[c];
  const int end = a.offsets[c + 1];
  int32_t* pts = reinterpret_cast<int32_t*>(buf + rows * 18 + 4);
  float* zs = buf + rows * 19 + 4;
  float acc = 0.0f;        // lane k < 6: back[k]
  for (int s = begin; s < end; s += rows) {
    const int n = min(rows, end - s);
    for (int i = lane; i < n; i += 32) copy4(pts + i, a.pt + s + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const int shift = stage_rows(a.w, s, n, buf, lane, 32);
    copies_but_last_done();              // the points (Wcp's rows may fly)
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      const float* zp = a.z + static_cast<int64_t>(pts[i]) * 3;
      copy4(zs + 3 * i, zp);
      copy4(zs + 3 * i + 1, zp + 1);
      copy4(zs + 3 * i + 2, zp + 2);
    }
    copies_done();
    __syncwarp();
#pragma unroll 4
    for (int i = lane; i < n; i += 32) {  // row i's y over its first floats
      float2* wi = reinterpret_cast<float2*>(buf + shift + 18 * i);
      float w[18];
#pragma unroll
      for (int m = 0; m < 9; ++m) {
        const float2 v = wi[m];
        w[2 * m] = v.x;
        w[2 * m + 1] = v.y;
      }
      const float z0 = zs[3 * i], z1 = zs[3 * i + 1], z2 = zs[3 * i + 2];
      float y[6];
#pragma unroll
      for (int k = 0; k < 6; ++k)
        y[k] = fadd(fadd(fmul(w[k * 3], z0), fmul(w[k * 3 + 1], z1)),
                    fmul(w[k * 3 + 2], z2));
#pragma unroll
      for (int m = 0; m < 3; ++m) wi[m] = make_float2(y[2 * m], y[2 * m + 1]);
    }
    __syncwarp();
    if (lane < 6) {       // in walk order, one add at a time (a zero
      const float* col = buf + shift + lane;   // past n: acc is never -0)
      for (int i = 0; i < n; i += kChain) {
        float v[kChain];
#pragma unroll
        for (int u = 0; u < kChain; ++u)
          v[u] = i + u < n ? col[18 * (i + u)] : 0.0f;
#pragma unroll
        for (int u = 0; u < kChain; ++u) acc = fadd(acc, v[u]);
      }
    }
    __syncwarp();   // the buffer is read before the next rows land
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) back[k] = __shfl_sync(kAll, acc, k);
}

// v[k] with the array kept in registers (a lane-dependent index would put
// it in local memory)
__device__ __forceinline__ float pick6(const float v[6], int k) {
  float out = v[0];
#pragma unroll
  for (int l = 1; l < 6; ++l) out = k == l ? v[l] : out;
  return out;
}

// lane k's loads of camera c for its update (x, r, p, Ap, D^-1 row k)
__device__ __forceinline__ Cam load_cam(const CameraArgs& a, int c, int k) {
  Cam v;
  v.c = c;
  v.p = a.p[c * 6 + k];
  v.x = a.x[c * 6 + k];
  v.r = a.r[c * 6 + k];
  v.ap = a.ap[c * 6 + k];
  v.z = 0.0f;
#pragma unroll
  for (int l = 0; l < 6; ++l) v.d[l] = a.d_inv[c * 36 + k * 6 + l];
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
schur_camera_kernel(const CameraArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kThreads];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = min(lane, 5);
  const int C = a.n_cams;
  const int first = blockIdx.x + gridDim.x * warp;   // this warp's cameras
  const int stride = gridDim.x * kWarps;
  // the block's warps that have a camera split its buffers
  const int active = min(kWarps, (C + static_cast<int>(gridDim.x) - 1) /
                                     static_cast<int>(gridDim.x));
  const int share = (a.smem_floats / active) & ~3;  // floats, 16-byte multiple
  const int rows = ((share - 4) / kCamRowFloats) & ~3;
  float* buf = smem + warp * share;
  Cam kept;                // the warp's last camera, for the update
  kept.c = -1;
  for (int c = first; c < C; c += stride) {
    if (a.raw) {
      float back[6];
      camera_sums(a, c, buf, rows, lane, back);
      if (lane < 6) a.ap[c * 6 + lane] = pick6(back, lane);
      continue;
    }
    float pv[6], h[6];     // the independent loads before the walk
    const float f = a.cam_free[c];
#pragma unroll
    for (int l = 0; l < 6; ++l) {
      pv[l] = a.p[c * 6 + l];
      h[l] = a.hcc_d[c * 36 + k * 6 + l];
    }
    kept.c = c;
    kept.x = a.x[c * 6 + k];
    kept.r = a.r[c * 6 + k];
#pragma unroll
    for (int l = 0; l < 6; ++l) kept.d[l] = a.d_inv[c * 36 + k * 6 + l];
    float back[6];
    camera_sums(a, c, buf, rows, lane, back);
    const float nf = 1.0f - f;
    float xm[6];
#pragma unroll
    for (int l = 0; l < 6; ++l) xm[l] = fmul(pv[l], f);
    float hx = fmul(h[0], xm[0]);
#pragma unroll
    for (int l = 1; l < 6; ++l) hx = fadd(hx, fmul(h[l], xm[l]));
    const float ap = fadd(fmul(fsub(hx, pick6(back, k)), f),
                          fmul(pick6(xm, k), nf));
    float q = 0.0f;
#pragma unroll
    for (int l = 0; l < 6; ++l) {
      const float apl = __shfl_sync(kAll, ap, l);
      q = l == 0 ? fmul(pv[0], apl) : fadd(q, fmul(pv[l], apl));
    }
    if (lane < 6) a.ap[c * 6 + lane] = ap;
    if (lane == 0) a.part[c] = q;
    kept.p = pick6(pv, k);
    kept.ap = ap;
  }
  if (a.raw) return;       // a mesh rank's sums alone: no barrier

  __shared__ float s_rz;
  cg::grid_group grid = cg::this_grid();
  grid.sync();             // every camera's p.Ap is written
  if (threadIdx.x == 0) s_rz = __ldcg(a.rz);   // one load a block
  const float pap = fixed_sum(a.part, C, red);  // (its barriers publish s_rz)
  const float rz = s_rz;
  const float alpha = fabsf(pap) > kGuard ? __fdiv_rn(rz, pap) : 0.0f;
  for (int c = first; c < C; c += stride) {
    Cam v = c == kept.c ? kept : load_cam(a, c, k);
    const float xn = fadd(v.x, fmul(alpha, v.p));
    const float rn = fsub(v.r, fmul(alpha, v.ap));
    float rv[6];
#pragma unroll
    for (int l = 0; l < 6; ++l) rv[l] = __shfl_sync(kAll, rn, l);
    float zk = fmul(v.d[0], rv[0]);
#pragma unroll
    for (int l = 1; l < 6; ++l) zk = fadd(zk, fmul(v.d[l], rv[l]));
    float q = 0.0f;
#pragma unroll
    for (int l = 0; l < 6; ++l) {
      const float zl = __shfl_sync(kAll, zk, l);
      q = l == 0 ? fmul(rv[0], zl) : fadd(q, fmul(rv[l], zl));
    }
    if (lane < 6) {
      a.x[c * 6 + lane] = xn;
      a.r[c * 6 + lane] = rn;
      a.ap[c * 6 + lane] = zk;
    }
    if (lane == 0) a.part[C + c] = q;
    if (c == kept.c) kept.z = zk;
  }
  grid.sync();             // every camera's r.z is written
  const float rz_new = fixed_sum(a.part + C, C, red);
  const float beta = fabsf(rz) > kGuard ? __fdiv_rn(rz_new, rz) : 0.0f;
  for (int c = first; c < C; c += stride) {
    const bool mine = c == kept.c;
    const float zk = mine ? kept.z : a.ap[c * 6 + k];
    const float pk = mine ? kept.p : a.p[c * 6 + k];
    if (lane < 6) a.p[c * 6 + lane] = fadd(zk, fmul(beta, pk));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) a.rz[0] = rz_new;
}

}  // namespace

// w: [E, 18] float32 (the point walk's rows, 16-byte aligned), cam: [E]
// int32, offsets: [P + 1] int32, x: [C, 6] (8-byte aligned), cam_free:
// [C], hinv: [P, 9] float32; out: [P, 3] float32 (z, or with raw the
// sums).  The block: 128 threads where P gives two blocks an SM at that,
// else 64 or 32; its buffer ~1.2 E / P rows a thread, 64 to
// kPointRowsMax.
extern "C" int airdos_schur_point(const void* w, const void* cam,
                                  const void* offsets, const void* x,
                                  const void* cam_free, const void* hinv,
                                  int n_points, int n_rows, int raw,
                                  void* out, void* stream) {
  if (n_points <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int threads = kPointThreads;
  while (threads > 32 && n_points < 2 * sms * threads) threads /= 2;
  int64_t want = (int64_t{12} * threads * n_rows / n_points + 9) / 10;
  want = (want < 64 ? 64 : want + 3) & ~int64_t{3};
  const int rows = static_cast<int>(want < kPointRowsMax ? want : kPointRowsMax);
  const int blocks = (n_points + threads - 1) / threads;
  const size_t smem = static_cast<size_t>(rows) * 19 * 4 + 16;
  schur_point_kernel<<<blocks, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const int32_t*>(cam),
      static_cast<const int32_t*>(offsets), static_cast<const float*>(x),
      static_cast<const float*>(cam_free), static_cast<const float*>(hinv),
      n_points, rows, raw, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Sets the camera kernel's shared memory on the current device and
// writes out[0] its cudaDevAttrCooperativeLaunch, out[1] its SMs, out[2]
// the camera blocks an SM holds at once.  Call once a device before its
// first airdos_schur_camera.
extern "C" int airdos_schur_residency(int* out) {
  const void* fn = reinterpret_cast<const void*>(schur_camera_kernel);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kCamSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[0], cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], schur_camera_kernel, kThreads, kCamSmem);
  return static_cast<int>(e);
}

// w: [E, 18] float32 (the camera walk's rows, 16-byte aligned), pt: [E]
// int32, offsets: [C + 1] int32, z: [P, 3], hcc_d, d_inv: [C, 36],
// cam_free: [C]; the CG state x, r, p: [C, 6], rz: [1]; ap: [C, 6]
// scratch (raw: the output back), part: [2, C] scratch.  grid: the
// update's blocks, 1 to C and at most the SMs times the blocks an SM
// holds (airdos_schur_residency): its launch is cooperative, a block's
// buffers 1.25 E / C + 32 rows for each warp with a camera, at most
// kCamSmem.  Raw: the same launch, which writes back and stops.
extern "C" int airdos_schur_camera(
    const void* w, const void* pt, const void* offsets, const void* z,
    const void* hcc_d, const void* d_inv, const void* cam_free, void* x,
    void* r, void* p, void* rz, void* ap, void* part, int n_cams,
    int n_rows, int raw, int grid, void* stream) {
  if (n_cams <= 0) return static_cast<int>(cudaGetLastError());
  if (grid < 1 || grid > n_cams || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  a.n_cams = n_cams;
  a.raw = raw;
  const int active = min(kWarps, (n_cams + grid - 1) / grid);
  const int64_t rows = int64_t{5} * n_rows / (int64_t{4} * n_cams) + 36;
  const int64_t need = active * (rows * kCamRowFloats + 8);
  const int smem_floats = static_cast<int>(
      need < kCamSmem / 4 ? (need + 3) & ~int64_t{3} : kCamSmem / 4);
  a.smem_floats = smem_floats;
  cudaLaunchAttribute coop = {};
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_floats) * 4;
  cfg.stream = s;
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, schur_camera_kernel, a);
  const cudaError_t last = cudaGetLastError();   // and clear it
  return static_cast<int>(e != cudaSuccess ? e : last);
}
