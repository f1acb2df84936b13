"""The vocabulary's tree descent: the plain version of csrc/voc_transform.cu
against airdos_tpu's _transform_device (CPU), and the kernel source
compiled for the host against the plain version.  Stated tolerance: bit
for bit everywhere (word ids and FeatureVector groups are integers), on
the scene vocabulary System trains (k 8, depth 3, from a frame's ORB
descriptors), on the same tree with its node ids shuffled out of breadth
first order, on random full trees of k 10 and depth 4 (a node with
fewer children, descriptors at ties; 11,111 nodes, more than the
kernel's shared budget stages, so that the walk reads the lower levels
from global memory), and with every node a leaf; the host build also
with every count of staged nodes from none to all.  CPU tensors take the
plain version and count no launch; the kernel's wrapper raises on a CPU
tensor.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from airdos_tpu.bow.vocabulary import Vocabulary as JaxVocabulary
from airdos_tpu.bow.vocabulary import train_vocabulary as jax_train
import airdos_tpu_torch.ops.voc_kernels as vk
from airdos_tpu_torch.bow.vocabulary import Vocabulary
from airdos_tpu_torch.convert import desc_to_tensor

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_kernel_host as kh  # noqa: E402
import torch_ransac_cases as trc  # noqa: E402
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)


def _trees():
    """(name, children, node_desc32, word_id, k, depth, descriptors)."""
    rng = np.random.default_rng(21)
    # System's scene vocabulary (slam/system.py: k 8, depth 3) from
    # descriptors clustered around 40 centres, as a frame's are
    centres = rng.integers(0, 256, (40, 32), dtype=np.uint8)
    flips = (rng.random((2400, 32, 8)) < 0.08)
    train = centres[rng.integers(0, 40, 2400)] ^ np.packbits(flips, axis=-1)[
        ..., 0]
    voc = jax_train(train, k=8, depth=3)
    query = (centres[rng.integers(0, 40, 700)] ^ np.packbits(
        rng.random((700, 32, 8)) < 0.1, axis=-1)[..., 0])
    q32 = query.view(np.uint32).reshape(-1, 8)
    out = [("scene k8 d3", voc.children, voc.node_desc32, voc.word_id, 8, 3,
            q32)]
    children, desc, word_id = trc.full_tree(4, 10, 4)
    children[3, 4:] = -1                     # a node with 4 children
    desc[40:50] = desc[40]                   # siblings at a tie
    out.append(("full k10 d4", children, desc, word_id, 10, 4,
                np.concatenate([trc.words(5, 500), desc[40:41]])))
    leaves = np.full((1, 5), -1, np.int32)
    out.append(("a root alone", leaves, trc.words(6, 1), np.zeros(1, np.int32),
                5, 3, trc.words(7, 9)))
    out.insert(1, ("scene k8 d3 shuffled",) + _shuffled(
        np.random.default_rng(22), *out[0][1:4]) + out[0][4:])
    return out


def _shuffled(rng, children, desc, word_id):
    """The same tree with every node but the root under a random new id:
    (children, node descriptors, word ids) in the new numbering."""
    nodes = len(word_id)
    new = np.concatenate([[0], 1 + rng.permutation(nodes - 1)])
    old = np.argsort(new)                       # old id of each new id
    ch = children[old]
    ch = np.where(ch >= 0, new[np.maximum(ch, 0)], -1).astype(np.int32)
    return ch, desc[old], word_id[old]


TREES = _trees()


def _vocabulary(cls, children, desc, word_id, k, depth, **kw):
    n_words = int((word_id >= 0).sum())
    return cls(k=k, depth=depth, node_desc32=desc, children=children,
               word_id=word_id, weights=np.ones(n_words, np.float32),
               n_words=n_words, feature_level=1, **kw)


@pytest.mark.parametrize("case", TREES, ids=[t[0] for t in TREES])
def test_plain_version_matches_jax(case):
    _, children, desc, word_id, k, depth, q = case
    jv = _vocabulary(JaxVocabulary, children, desc, word_id, k, depth)
    want = [np.asarray(a) for a in jax.device_get(
        jv._jit_transform(q.astype(np.uint32)))]
    tv = _vocabulary(Vocabulary, children, desc, word_id, k, depth,
                     device="cpu")
    got = vk.voc_transform_ref(*tv._device_tables(),
                               desc_to_tensor(q, "cpu"), depth)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert got[0].dtype == got[1].dtype == torch.int32


@pytest.fixture(scope="module")
def host_voc(tmp_path_factory):
    glue = """
extern "C" void host_voc(const VocParams* p) {
  for (long long i = 0; i < p->n; ++i) { blockIdx.x = i; voc_transform_kernel<1>(*p); }
}
"""
    return kh.build("voc_transform.cu", glue,
                    tmp_path_factory.mktemp("voc"))


def _host_transform(lib, tables, d, depth, staged):
    """One emulated launch of voc_transform.cu with `staged` nodes in
    shared memory: (word ids, groups)."""
    nodes, k = tables[0].shape
    assert vk.stage_bytes(staged, k) <= vk.STAGE_BUDGET
    n = d.shape[0]
    out = torch.empty((2, n), dtype=torch.int32)
    kh.call(lib.host_voc, vk._PARAMS.pack(
        n, k, depth, staged, *(t.data_ptr() for t in tables), d.data_ptr(),
        out.data_ptr(), out.data_ptr() + 4 * n))
    return out[0], out[1]


@pytest.mark.parametrize("case", TREES, ids=[t[0] for t in TREES])
def test_kernel_source_on_the_host_is_bit_equal(host_voc, case):
    _, children, desc, word_id, k, depth, q = case
    tv = _vocabulary(Vocabulary, children, desc, word_id, k, depth,
                     device="cpu")
    tables = tv._device_tables()
    d = desc_to_tensor(q, "cpu")
    got = _host_transform(host_voc, tables, d, depth,
                          vk.staged_nodes(len(word_id), k))
    want = vk.voc_transform_ref(*tables, d, depth)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", TREES[:3], ids=[t[0] for t in TREES[:3]])
def test_kernel_source_on_the_host_at_every_staging(host_voc, case):
    """The result does not depend on how many nodes are staged: none, the
    root, part of a level, a whole level, all the budget holds."""
    _, children, desc, word_id, k, depth, q = case
    tv = _vocabulary(Vocabulary, children, desc, word_id, k, depth,
                     device="cpu")
    tables = tv._device_tables()
    d = desc_to_tensor(q[:200], "cpu")
    want = vk.voc_transform_ref(*tables, d, depth)
    most = vk.staged_nodes(len(word_id), k)
    for staged in sorted({0, 1, 5, 1 + k, 37, most}):
        got = _host_transform(host_voc, tables, d, depth, min(staged, most))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_the_budget_stages_the_top_levels():
    """The scene trees (k 8, depth 3, up to 585 nodes on the paths) whole,
    and ORBvoc's shape (k 10, depth 6) down to level 2 with part of level
    3, within STAGE_BUDGET; a tree of k 16 part of its level 3."""
    scene = TREES[0]
    assert vk.staged_nodes(len(scene[3]), 8) == len(scene[3])
    assert vk.staged_nodes(585, 8) == 585
    assert 111 < vk.staged_nodes(1_111_111, 10) < 1_111
    big = vk.staged_nodes(1 + 16 + 256 + 4096, 16)
    assert 1 + 16 < big < 1 + 16 + 256 + 4096
    for nodes, k in ((1_111_111, 10), (10 ** 6, 16), (10 ** 6, 1)):
        s = vk.staged_nodes(nodes, k)
        assert vk.stage_bytes(s, k) <= vk.STAGE_BUDGET < \
            vk.stage_bytes(s + 1, k)


def test_cpu_takes_the_plain_version(monkeypatch):
    def kernel(*args, **kwargs):
        raise AssertionError("the kernel wrapper ran on a CPU tensor")

    _, children, desc, word_id, k, depth, q = TREES[2]
    tv = _vocabulary(Vocabulary, children, desc, word_id, k, depth,
                     device="cpu")
    n = vk.launches()
    with monkeypatch.context() as m:
        m.setattr(vk, "voc_transform_cuda", kernel)
        bow, wids, _ = tv.transform(q)
    assert len(bow) > 0 and (wids >= 0).all()
    with pytest.raises(ValueError):
        vk.voc_transform_cuda(*tv._device_tables(), desc_to_tensor(q, "cpu"),
                              depth)
    assert vk.launches() == n
