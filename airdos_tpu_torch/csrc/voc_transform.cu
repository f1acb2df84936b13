// The bag-of-words vocabulary's tree descent, for sm_90a: one kernel,
// voc_transform, one launch a Vocabulary.transform.
//
// Replaces airdos_tpu/bow/vocabulary.py:75 _transform_device, a loop over
// the tree's levels of gathers and a Hamming argmin that XLA runs as ~8
// ops a level; the port's plain version (ops/voc_kernels.py
// voc_transform_ref) runs the same ops as eager torch, a launch each.
//
// A thread a descriptor walks the tree from the root: at each level it
// reads the k child ids of its node, and each existing child's 8-word
// descriptor, takes the Hamming distances to its own 8 words (popcount of
// the XOR; 1 << 20 for a missing child), and moves to the first child of
// the least distance, as torch.argmin and jnp.argmin pick it; a node
// without children keeps the descriptor where it is.  At the end it
// writes the node's word id and its FeatureVector group.  All integer:
// the outputs equal the plain version's bit for bit.
//
// What bounds it on an H100.  A descriptor reads depth x (4 k + 32 k)
// bytes of the tree (2.2 KB at k 10, depth 6) and its own 32 bytes, and
// writes 8: ~3.3 MB for 1500 descriptors, 1 us at 3.35 TB/s; the
// operations (~30 a child a level) are fewer still.  The tree's nodes are
// scattered, so each level is two dependent gathers (the child ids, then
// their descriptors) from L2 or HBM: depth x 2 load latencies a thread,
// with 1500 threads far too few to hide them, is what a launch costs.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

// the layout of ops/voc_kernels.py _PARAMS
struct VocParams {
  long long n;               // descriptors
  long long k;               // branching factor (<= kMaxK)
  long long depth;           // levels below the root
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

__global__ void __launch_bounds__(kThreads) voc_transform_kernel(const VocParams q) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= q.n) return;
  unsigned d[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) d[w] = static_cast<unsigned>(q.desc[8 * i + w]);
  const int k = static_cast<int>(q.k);
  long long cur = 0;
  for (long long level = 0; level < q.depth; ++level) {
    int ch[kMaxK];
#pragma unroll
    for (int c = 0; c < kMaxK; ++c) ch[c] = c < k ? q.children[cur * k + c] : -1;
    int best = -1, best_d = 0x7fffffff;
    bool any = false;
#pragma unroll
    for (int c = 0; c < kMaxK; ++c) {
      if (c >= k) break;
      int dist = kMissing;
      if (ch[c] >= 0) {
        const int* nd = q.node_desc + 8LL * ch[c];
        dist = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) dist += __popc(static_cast<unsigned>(nd[w]) ^ d[w]);
        any = true;
      }
      if (dist < best_d) {
        best_d = dist;
        best = ch[c];
      }
    }
    if (any) cur = best;
  }
  q.words[i] = q.word_id[cur];
  q.groups[i] = q.group_of[cur];
}

}  // namespace

// ---- launch

extern "C" int airdos_voc_transform(const VocParams* params, void* stream) {
  const VocParams& q = *params;
  if (q.n <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((q.n + kThreads - 1) / kThreads);
  voc_transform_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}
