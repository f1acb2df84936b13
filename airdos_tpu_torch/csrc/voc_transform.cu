// The bag-of-words vocabulary's tree descent, for sm_90a: one kernel,
// voc_transform, one launch a Vocabulary.transform.
//
// Replaces airdos_tpu/bow/vocabulary.py:75 _transform_device, a loop over
// the tree's levels of gathers and a Hamming argmin that XLA runs as ~8
// ops a level; the port's plain version (ops/voc_kernels.py
// voc_transform_ref) runs the same ops as eager torch, a launch each.
//
// A group of G lanes (k rounded up to a power of two, at most 16) walks
// one descriptor down the tree from the root: at each level lane c reads
// child c's id and its 8-word descriptor (two 16-byte loads), takes the
// Hamming distance to the descriptor's own 8 words (popcount of the XOR;
// 1 << 20 for a missing child), and shuffles inside the group take the
// least distance, the first child on ties, as torch.argmin and
// jnp.argmin pick it; a node without children keeps the descriptor where
// it is.  At the end lane 0 writes the node's word id and its
// FeatureVector group.  All integer: the outputs equal the plain
// version's bit for bit.
//
// The tree's first `staged` nodes (their descriptors, child ids, word ids
// and groups) are copied into each block's shared memory once, by 16-byte
// asynchronous copies, before the walk: a node below `staged` is read
// from there, any other from global memory.  The wrapper
// (ops/voc_kernels.py staged_nodes) stages as many nodes as kStageBudget
// bytes hold.  Trees from train_vocabulary and DBoW2 files number their
// nodes breadth first, so the budget covers their top levels: the scene
// trees System trains (k 8, depth 3, up to 585 nodes) whole, levels 0-2
// and part of level 3 of k 10 and depth 6.  The result does not depend
// on that order.  The budget is 48 KB: on the card a larger one staged
// more of the k 10 tree at a cost above what it saved (tools/
// kernel_split.py times the kernel at budgets of 0-96 KB).
//
// What bounds it on an H100.  A descriptor reads depth x (4 k + 32 k)
// bytes of the tree (2.2 KB at k 10, depth 6) and its own 32 bytes, and
// writes 8: ~3.3 MB for 1500 descriptors, 1 us at 3.35 TB/s; the
// operations (~30 a child a level) are fewer still.  The walk is a chain
// of dependent loads, depth x 2 deep: from shared memory for the staged
// levels, which also takes the chain off the first levels' few hot nodes
// that every descriptor visits, and from L2 or HBM below them, with k
// lanes a descriptor so that a launch fills more SMs (96 blocks at N 1536
// and k 8).  The staging is one trip a block of at most 48 KB from L2.
//
// A host build (tests/torch_kernel_host.py) instantiates G = 1: one lane
// walks the k children in turn and the shuffles do nothing, the same
// argmin.  The C entry point launches on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

// the layout of ops/voc_kernels.py _PARAMS
struct VocParams {
  long long n;               // descriptors
  long long k;               // branching factor (<= kMaxK)
  long long depth;           // levels below the root
  long long staged;          // nodes [0, staged) staged in shared memory
  const int* children;       // [nodes, k], -1 none
  const int* node_desc;      // [nodes, 8] descriptor words
  const int* word_id;        // [nodes]
  const int* group_of;       // [nodes]
  const int* desc;           // [n, 8]
  int* words;                // [n]
  int* groups;               // [n]
};

namespace {

constexpr int kThreads = 128;
constexpr int kMaxK = 16;
constexpr int kMissing = 1 << 20;
constexpr long long kStageBudget = 48 * 1024;  // ops/voc_kernels.py STAGE_BUDGET
static_assert(kStageBudget <= 48 * 1024, "past 48 KB a launch needs the opt-in");

__host__ __device__ __forceinline__ long long round16(long long bytes) {
  return (bytes + 15) / 16 * 16;
}

// shared bytes of `staged` nodes: descriptors, child ids, word ids, groups
__host__ __device__ __forceinline__ long long stage_bytes(long long staged,
                                                          long long k) {
  return 32 * staged + round16(4 * k * staged) + 2 * round16(4 * staged);
}

// copy `bytes` from src to the shared dst by the block's threads, 16 bytes
// a copy (the last zero-filled past `bytes`); src and dst 16-byte aligned
__device__ __forceinline__ void stage_copy(void* dst, const void* src,
                                           long long bytes) {
  for (long long off = 16LL * threadIdx.x; off < bytes; off += 16LL * blockDim.x) {
    const long long left = bytes - off;
    const int len = left < 16 ? static_cast<int>(left) : 16;
#ifdef __CUDA_ARCH__
    const unsigned d = static_cast<unsigned>(
        __cvta_generic_to_shared(static_cast<unsigned char*>(dst) + off));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(static_cast<const unsigned char*>(src) + off), "r"(len)
                 : "memory");
#else
    unsigned char* o = static_cast<unsigned char*>(dst) + off;
    const unsigned char* s = static_cast<const unsigned char*>(src) + off;
    for (int b = 0; b < 16; ++b) o[b] = b < len ? s[b] : 0;
#endif
  }
}

__device__ __forceinline__ void stage_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
#endif
}

__device__ __forceinline__ uint4 load16(const int* p, bool shared) {
#ifdef __CUDA_ARCH__
  if (!shared) return __ldg(reinterpret_cast<const uint4*>(p));
#endif
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ int hamming(uint4 a, uint4 b, const unsigned (&d)[8]) {
  return __popc(a.x ^ d[0]) + __popc(a.y ^ d[1]) + __popc(a.z ^ d[2]) +
         __popc(a.w ^ d[3]) + __popc(b.x ^ d[4]) + __popc(b.y ^ d[5]) +
         __popc(b.z ^ d[6]) + __popc(b.w ^ d[7]);
}

template <int G>
__global__ void __launch_bounds__(kThreads) voc_transform_kernel(const VocParams q) {
#ifdef __CUDACC__
  extern __shared__ __align__(16) unsigned char voc_stage[];
#else
  alignas(16) static unsigned char voc_stage[kStageBudget];
#endif
  const int k = static_cast<int>(q.k);
  const long long S = q.staged;
  int* sdesc = reinterpret_cast<int*>(voc_stage);
  int* schild = reinterpret_cast<int*>(voc_stage + 32 * S);
  int* sword = reinterpret_cast<int*>(voc_stage + 32 * S + round16(4LL * k * S));
  int* sgroup = sword + round16(4 * S) / 4;
  stage_copy(sdesc, q.node_desc, 32 * S);
  stage_copy(schild, q.children, 4LL * k * S);
  stage_copy(sword, q.word_id, 4 * S);
  stage_copy(sgroup, q.group_of, 4 * S);

  const int lane = static_cast<int>(threadIdx.x) % G;
  const long long i = static_cast<long long>(blockIdx.x) * (blockDim.x / G) +
                      threadIdx.x / G;
  unsigned d[8];
  if (i < q.n) {                           // while the copies land
    const uint4 a = load16(q.desc + 8 * i, false);
    const uint4 b = load16(q.desc + 8 * i + 4, false);
    d[0] = a.x, d[1] = a.y, d[2] = a.z, d[3] = a.w;
    d[4] = b.x, d[5] = b.y, d[6] = b.z, d[7] = b.w;
  }
  stage_wait();
  __syncthreads();
  if (i >= q.n) return;                    // the whole group: i is its own
  const unsigned group_mask =
      G >= 32 ? 0xffffffffu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  long long cur = 0;
  for (long long level = 0; level < q.depth; ++level) {
    const int* row = cur < S ? schild + cur * k : q.children + cur * k;
    int best_key = 0x7fffffff, best = -1;  // key: distance x 16 + child
    for (int c = lane; c < k; c += G) {
      const int ch = row[c];
      int dist = kMissing;
      if (ch >= 0) {
        const bool sh = ch < S;
        const int* nd = (sh ? sdesc : q.node_desc) + 8LL * ch;
        dist = hamming(load16(nd, sh), load16(nd + 4, sh), d);
      }
      const int key = dist * kMaxK + c;
      if (key < best_key) {
        best_key = key;
        best = ch;
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      const int other_key = __shfl_xor_sync(group_mask, best_key, off);
      const int other = __shfl_xor_sync(group_mask, best, off);
      if (other_key < best_key) {
        best_key = other_key;
        best = other;
      }
    }
    if (best_key / kMaxK < kMissing) cur = best;   // else a leaf: stay
  }
  if (lane == 0) {
    q.words[i] = cur < S ? sword[cur] : q.word_id[cur];
    q.groups[i] = cur < S ? sgroup[cur] : q.group_of[cur];
  }
}

}  // namespace

// ---- launch

namespace {

template <int G>
int launch(const VocParams& q, long long smem, cudaStream_t stream) {
  const long long per_block = kThreads / G;
  const unsigned blocks = static_cast<unsigned>((q.n + per_block - 1) / per_block);
  voc_transform_kernel<G><<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int airdos_voc_transform(const VocParams* params, void* stream) {
  const VocParams& q = *params;
  if (q.n <= 0) return static_cast<int>(cudaGetLastError());
  const long long smem = stage_bytes(q.staged, q.k);
  if (q.k < 1 || q.k > kMaxK || q.staged < 0 || smem > kStageBudget)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q.k <= 1) return launch<1>(q, smem, s);
  if (q.k <= 2) return launch<2>(q, smem, s);
  if (q.k <= 4) return launch<4>(q, smem, s);
  if (q.k <= 8) return launch<8>(q, smem, s);
  return launch<16>(q, smem, s);
}
