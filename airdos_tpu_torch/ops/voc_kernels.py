"""The vocabulary's tree descent: a CUDA kernel + its plain twin.

``Vocabulary.transform`` (bow/vocabulary.py) turns a frame's descriptors
into word ids and FeatureVector groups by descending the k-ary tree from
the root, as airdos_tpu/bow/vocabulary.py:75 _transform_device does.

- ``voc_transform_ref`` is the plain version: at each level gather every
  descriptor's k children and their descriptors, take the Hamming
  distances (1 << 20 for a missing child) and the first argmin, and stay
  put at a leaf; a few eager ops a level.
- ``voc_transform`` on a CUDA descriptor tensor launches
  ``csrc/voc_transform.cu`` (the tree's first ``staged_nodes`` nodes in
  each block's shared memory, a lane a child and a group of lanes a
  descriptor walking the whole tree) on the calling thread's current
  stream, or raises, and counts the launch, by thread and stream priority
  too; on a CPU tensor it runs the plain version.

The tree is the vocabulary's device tables (int32: children [nodes, k],
node descriptors [nodes, 8] as bit views, word ids and groups [nodes]).
Both versions are integer throughout and equal bit for bit.
"""
from __future__ import annotations

import ctypes
import struct

import torch

from airdos_tpu_torch.ops import cuda_build
from airdos_tpu_torch.ops.hamming_kernels import _popcount32

MISSING = 1 << 20            # a missing child's distance
MAX_K = 16                   # csrc/voc_transform.cu kMaxK
STAGE_BUDGET = 48 * 1024     # csrc/voc_transform.cu kStageBudget: shared bytes


def _round16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def stage_bytes(staged: int, k: int) -> int:
    """Shared bytes of `staged` nodes in csrc/voc_transform.cu's layout:
    descriptors, child ids, word ids and groups, each 16-byte aligned."""
    return 32 * staged + _round16(4 * k * staged) + 2 * _round16(4 * staged)


def staged_nodes(nodes: int, k: int) -> int:
    """How many of a tree's first nodes the kernel stages: all of them, or
    as many as STAGE_BUDGET holds."""
    s = min(nodes, STAGE_BUDGET // (4 * k + 40))
    while stage_bytes(s, k) > STAGE_BUDGET:
        s -= 1
    return s


def voc_transform_ref(children, node_desc, word_id, group_of,
                      desc32: torch.Tensor, depth: int):
    """Plain version.  desc32 [N, 8] int32 bit views -> (word ids [N],
    node at the feature level [N]), int32."""
    N = desc32.shape[0]
    d64 = desc32.to(torch.int64) & 0xFFFFFFFF
    cur = torch.zeros(N, dtype=torch.int64, device=desc32.device)
    for _ in range(depth):
        ch = children[cur]                                  # [N, k]
        cd = node_desc[torch.clamp(ch, min=0)].to(torch.int64) & 0xFFFFFFFF
        dist = _popcount32(cd ^ d64[:, None, :]).sum(-1)
        dist = torch.where(ch >= 0, dist, torch.full_like(dist, MISSING))
        best = torch.argmin(dist, dim=-1)
        nxt = torch.gather(ch, 1, best[:, None])[:, 0].to(torch.int64)
        # stop at leaves (stay put when no children)
        cur = torch.where((ch >= 0).any(dim=-1), nxt, cur)
    return word_id[cur], group_of[cur]


# ------------------------------------------------------------------ kernel

# csrc/voc_transform.cu VocParams: 4 counts and 7 pointers
_PARAMS = struct.Struct("<11q")
_SOURCE = cuda_build.CSRC / "voc_transform.cu"
_SIGNATURES = {"airdos_voc_transform": [ctypes.c_void_p, ctypes.c_void_p]}
_lib = None                     # the loaded library, once built

_counter = cuda_build.LaunchCounter()


def launches() -> int:
    """voc_transform launches since the last reset_launches()."""
    return _counter.total


def launch_tally() -> dict:
    """{("voc_transform", thread name, stream priority): launches} since
    the last reset_launches()."""
    return {("voc_transform",) + key: n for key, n in _counter.tally().items()}


def reset_launches() -> None:
    _counter.reset()


def build():
    """Compile csrc/voc_transform.cu for sm_90a into _build/ and return the
    library's path."""
    return cuda_build.build(_SOURCE)


def voc_transform_cuda(children, node_desc, word_id, group_of,
                       desc32: torch.Tensor, depth: int):
    """Launch the kernel on the current stream: one launch."""
    global _lib
    dev = desc32.device
    if not desc32.is_cuda:
        raise ValueError(f"desc32 must be a CUDA tensor, got {dev}")
    if children.dim() != 2:
        raise ValueError(f"children must be [nodes, k], got "
                         f"{tuple(children.shape)}")
    nodes, k = children.shape
    i32 = torch.int32
    for name, x, shape in (("desc32", desc32, (None, 8)),
                           ("children", children, (nodes, k)),
                           ("node_desc", node_desc, (nodes, 8)),
                           ("word_id", word_id, (nodes,)),
                           ("group_of", group_of, (nodes,))):
        cuda_build.check_tensor(name, x, i32, shape, dev)
    if not 0 < k <= MAX_K or nodes == 0:
        raise ValueError(f"a tree of {nodes} nodes with k = {k}: the kernel "
                         f"takes 1 <= k <= {MAX_K} and a root")
    for name, x in (("children", children), ("node_desc", node_desc),
                    ("word_id", word_id), ("group_of", group_of),
                    ("desc32", desc32)):
        if x.data_ptr() % 16:            # the 16-byte copies and loads
            raise ValueError(f"{name} must start on 16 bytes")
    staged = staged_nodes(nodes, k)
    n = desc32.shape[0]
    out = torch.empty((2, n), dtype=i32, device=dev)
    if n:
        if _lib is None:
            _lib = cuda_build.library(_SOURCE, _SIGNATURES)
        block = ctypes.create_string_buffer(_PARAMS.pack(
            n, k, int(depth), staged, children.data_ptr(),
            node_desc.data_ptr(),
            word_id.data_ptr(), group_of.data_ptr(), desc32.data_ptr(),
            out.data_ptr(), out.data_ptr() + 4 * n))
        stream = torch.cuda.current_stream(dev)
        with cuda_build.on_device(dev):
            err = _lib.airdos_voc_transform(ctypes.addressof(block),
                                            stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"voc_transform kernel launch failed: "
                               f"cudaError {err}")
        _counter.count(stream.priority)
    return out[0], out[1]


def voc_transform(children, node_desc, word_id, group_of,
                  desc32: torch.Tensor, depth: int):
    """Word ids and groups of desc32's descriptors: a CUDA tensor goes to
    the kernel, a CPU tensor to the plain version."""
    args = (children, node_desc, word_id, group_of, desc32, depth)
    if desc32.is_cuda:
        return voc_transform_cuda(*args)
    return voc_transform_ref(*args)
