"""The launch plans of the redesigned kernels, on the CPU: which cells each
warp of csrc/select.cu's cluster scans, the bitonic network it runs (the
stages with j < 32 by warp shuffles, the rest in shared memory) and the
shared memory it admits; which edges each block of csrc/pose_lm.cu's
cluster takes.  The kernels themselves run on the card only
(tests/test_torch_cuda.py)."""
import numpy as np
import pytest

import airdos_tpu_torch.ops.select as sk

# level 0 of 640x360 at 1500 features (836 cells of 17 px), a whole
# pyramid's worth, and the edges of the cluster's 128 warps, of the sort's
# layouts and of the largest level the shared-memory check admits
CELL_COUNTS = (1, 7, 31, 127, 128, 129, 836, 4097, 4400, 12672)


def _largest_admitted() -> int:
    n = 1
    while sk.smem_bytes(n + 1) <= sk.MAX_SMEM:
        n += 1
    return n


@pytest.mark.parametrize("n", CELL_COUNTS)
def test_select_scan_takes_every_cell_once(n):
    seen = np.zeros(n, np.int64)
    for rank in range(sk.CLUSTER):
        for warp in range(sk.WARPS):
            for cell in sk.scan_cells(n, rank, warp):
                seen[cell] += 1
    assert (seen == 1).all()
    # the warps' loads differ by at most one cell
    per_warp = [len(sk.scan_cells(n, r, w)) for r in range(sk.CLUSTER)
                for w in range(sk.WARPS)]
    assert max(per_warp) - min(per_warp) <= 1


def _exchange(mine, other, i, k, j):
    """csrc/select.cu exchange(): the rule of the shuffle and thread
    stages, per word and its partner i ^ j."""
    keep_min = ((i & j) == 0) == ((i & k) == 0)
    return np.where(keep_min, np.minimum(mine, other),
                    np.maximum(mine, other))


def _network(words):
    """The kernel's network on words [p]: shuffle and thread stages by the
    exchange rule on each word and its partner i ^ j, shared-memory stages
    by the compare-exchange of the lower index of each pair."""
    w = words.copy()
    i = np.arange(len(w))
    for k, j, kind in sk.sort_stages(len(w)):
        if kind == "shared":
            lo = i[(i ^ j) > i]
            a, b = w[lo].copy(), w[lo ^ j].copy()
            swap = (a > b) == ((lo & k) == 0)
            w[lo] = np.where(swap, b, a)
            w[lo ^ j] = np.where(swap, a, b)
        else:
            w = _exchange(w, w[i ^ j], i, k, j)
    return w


@pytest.mark.parametrize("n", CELL_COUNTS)
def test_select_network_sorts_the_words(n):
    """Distinct keys and cell indices, the padding words (~0) last: the
    network's order is the stable sort's."""
    rng = np.random.default_rng(n)
    p = 1
    while p < n:
        p <<= 1
    keys = rng.integers(0, 4, n).astype(np.uint64)     # many equal keys
    words = np.full(p, np.iinfo(np.uint64).max, np.uint64)
    words[:n] = (keys << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    got = _network(words)
    assert np.array_equal(got, np.sort(words))
    assert np.array_equal(got[:n] & np.uint64(0xffffffff),
                          np.argsort(keys, kind="stable").astype(np.uint64))


def test_select_sort_barriers_and_register_words():
    # level 0 at 640x360: 1024 words, 2 a thread on 512 threads; 16 block
    # barriers against the 56 of a network run wholly in shared memory
    # (one at each of its 55 stages and one before)
    assert len(sk.sort_stages(836)) == 55
    kinds = [kind for _, _, kind in sk.sort_stages(836)]
    assert (kinds.count("shared"), kinds.count("shuffle"),
            kinds.count("thread")) == (10, 35, 10)
    assert sk.sort_barriers(836) == 16
    assert sk.sort_barriers(1) == 2 and sk.sort_barriers(32) == 2
    # every size up to the largest level the shared-memory check admits
    # has an instantiated word count, and its sorting threads fit the block
    n = _largest_admitted()
    assert n == 12672
    p = 1
    while p < n:
        p <<= 1
        words = sk.sort_words(p)
        assert words in (0, 1, 2, 4, 8)
        if words:
            # the sorting threads fit the block and fill a warp
            assert words * sk.THREADS >= p and 32 * words <= max(p, 32)
            # the shuffle stages stay inside a warp
            assert all(j // words < 32 for _, j, kind in sk.sort_stages(p)
                       if kind == "shuffle")
        else:
            # past SORT_WORDS * THREADS the network is in shared memory
            assert p > sk.SORT_WORDS * sk.THREADS
            assert {kind for _, _, kind in sk.sort_stages(p)} == {"shared"}
            assert sk.sort_barriers(p) == 1 + len(sk.sort_stages(p))
    assert sk.smem_bytes(n + 1) > sk.MAX_SMEM


@pytest.mark.parametrize("n", (0, 1, 3, 255, 256, 1023, 1536, 2048, 40960))
def test_pose_lm_cluster_takes_every_edge_once(n):
    import airdos_tpu_torch.solvers.pose_opt as po
    seen = np.zeros(n, np.int64)
    for rank in range(po.CLUSTER):
        block = po.cluster_edges(n, rank)
        assert block.step == 1
        seen[block.start:block.stop] += 1
        # a byte of flags an edge of the block, under the 48 KB a block
        # gets without opting in
        assert len(block) <= -(-po.MAX_EDGES // po.CLUSTER) <= 48 * 1024
    assert (seen == 1).all()
