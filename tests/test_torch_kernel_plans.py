"""The launch plans of the redesigned kernels, on the CPU: which cells each
warp of csrc/select.cu's cluster scans, the bitonic network it runs (the
stages with j < 32 by warp shuffles, the rest in shared memory) and the
shared memory it admits; which edges each block of csrc/pose_lm.cu's
cluster takes; which level each warp of csrc/orb_desc.cu's all-levels
launch describes; which of an edge's 72 Gauss-Newton floats each lane of
csrc/ba_static.cu computes, and the order of its fused LM cost; which
tile of which level each block of csrc/fast.cu's all-levels launch
computes, and which tiles each block of csrc/pyramid.cu's cooperative
launch computes in each phase; which Wagg rows each thread of
csrc/ba_points.cu's reduction takes, which points each block inverts and
which block writes a point's inverse, and which cameras each lane of the
back-substitution sums; which of an edge's Gauss-Newton floats each lane
of csrc/ba_human.cu computes, how a block writes its slices of the
column, and the order of its three fused LM costs.  The kernels
themselves run on the card only (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

import airdos_tpu_torch.ops.ba_human as bh
import airdos_tpu_torch.ops.ba_points as bp
import airdos_tpu_torch.ops.ba_static as bs
import airdos_tpu_torch.ops.fast as fk
import airdos_tpu_torch.ops.lm_cost as lc
import airdos_tpu_torch.ops.orb_kernels as ok
import airdos_tpu_torch.ops.pyramid as pk
import airdos_tpu_torch.ops.select as sk
from airdos_tpu_torch.ops import cuda_build

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


# ------------------------------------------------------------- orb_desc

ORB_QUOTAS = ((326,), (326, 271, 226, 189, 157, 131, 109, 91),
              (193, 161, 134, 112), (0, 5, 0, 0, 7, 0), (4, 0),
              tuple(range(16)), (3,) * 16, (0,) * 16)


@pytest.mark.parametrize("quotas", ORB_QUOTAS)
def test_orb_level_table_puts_every_slot_in_one_warp(quotas):
    """Global warp k describes slot k of the level the kernel's walk finds;
    every slot of every level (a level with quota 0 holds none) is
    described once, by a warp of its own level."""
    first = ok.level_table(quotas)
    total = sum(quotas)
    assert len(first) == len(quotas) <= ok.MAX_LEVELS
    seen = np.zeros(total, np.int64)
    for warp in range(total):
        lvl = ok.slot_level(warp, first)
        assert quotas[lvl] > 0
        assert first[lvl] <= warp < first[lvl] + quotas[lvl]
        seen[warp] += 1
    assert (seen == 1).all()
    # the slots of level l are quotas[l] consecutive warps from first[l]
    for lvl, (f, q) in enumerate(zip(first, quotas)):
        assert [ok.slot_level(k, first) for k in range(f, f + q)] == [lvl] * q


def _texture_levels(rng, shapes):
    from airdos_tpu_torch.ops.filters import gaussian_blur7
    images = [torch.from_numpy(np.round(rng.uniform(0, 255, s))
                               .astype(np.float32)) for s in shapes]
    return images, [gaussian_blur7(im) for im in images]


@pytest.mark.parametrize("quotas", ((40, 31, 0, 17), (0, 9), (25,)))
def test_orb_describe_levels_ref_is_the_levels_concatenated(quotas):
    rng = np.random.default_rng(sum(quotas))
    shapes = [(120 - 12 * i, 160 - 16 * i) for i in range(len(quotas))]
    images, blurred = _texture_levels(rng, shapes)
    xs = torch.from_numpy(np.concatenate(
        [rng.integers(0, w, q) for (h, w), q in zip(shapes, quotas)]))
    ys = torch.from_numpy(np.concatenate(
        [rng.integers(0, h, q) for (h, w), q in zip(shapes, quotas)]))
    ang, words = ok.orb_describe_levels(images, blurred, xs, ys, quotas)
    parts = [ok.orb_describe_ref(im, bl, xs[f:f + q], ys[f:f + q])
             for im, bl, f, q in zip(images, blurred, ok.level_table(quotas),
                                     quotas)]
    assert torch.equal(ang, torch.cat([a for a, _ in parts]))
    assert torch.equal(words, torch.cat([w for _, w in parts]))
    assert words.shape == (sum(quotas), 8) and words.dtype == torch.int32


def test_orb_describe_levels_cuda_rejects_what_it_does_not_take():
    im = torch.zeros((64, 64))
    xs = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        ok.orb_describe_levels_cuda([im], [im], xs, xs, [4])     # CPU
    with pytest.raises(ValueError):
        ok.orb_describe_levels_cuda([im] * 17, [im] * 17, xs, xs, [0] * 17)
    with pytest.raises(ValueError):
        ok.orb_describe_levels_cuda([im] * 2, [im], xs, xs, [2, 2])


def test_extractor_slot_scales_are_the_per_level_products():
    """Level-0 coordinates from the per-slot float32 scale table equal the
    per-level products by the level's float scale, bit for bit."""
    from airdos_tpu_torch.features.orb import OrbExtractor
    ex = OrbExtractor(1500, 1.2, 8)
    scale, octv = ex._slots_on(torch.device("cpu"))
    rng = np.random.default_rng(3)
    n = sum(ex.quotas)
    xs = torch.from_numpy(rng.integers(0, 640, n))
    ys = torch.from_numpy(rng.integers(0, 360, n))
    got = torch.stack([xs.float(), ys.float()], -1) * scale[:, None]
    for lvl, (f, q) in enumerate(zip(ok.level_table(ex.quotas), ex.quotas)):
        want = torch.stack([xs[f:f + q].float(), ys[f:f + q].float()],
                           -1) * ex.scale_factor ** lvl
        assert torch.equal(got[f:f + q], want)
        assert (octv[f:f + q] == lvl).all()
    assert octv.dtype == torch.int64 and octv.shape == (n,)


# -------------------------------------------------- static_edge_blocks

def test_gn_lane_plan_writes_every_entry_once():
    """The lanes' plan words put each of an edge's 72 Gauss-Newton floats
    in exactly one place, each lane at most SLOTS entries, the lanes'
    loads within one entry of each other."""
    plan = bs.gn_lane_plan()
    assert len(plan) == bs.LANES and all(len(w) == bs.SLOTS for w in plan)
    written = np.zeros(72, np.int64)
    per_lane = []
    for lane in plan:
        words = [w for w in lane if w >= 0]
        assert lane[len(words):] == [-1] * (bs.SLOTS - len(words))
        per_lane.append(len(words))
        for w in words:
            q, p, first, second, neg = bs.plan_entry(w)
            assert 0 <= q <= 9 and 0 <= p <= 9
            written[first] += 1
            if second != bs.NONE:
                written[second] += 1
    assert (written == 1).all()
    assert max(per_lane) - min(per_lane) <= 1


def _plan_rows(Jc, Jp, e, w):
    """The Gauss-Newton rows as the kernel's lanes compute them from the
    plan, in float64 with one rounding each: [E, 72]."""
    f64 = torch.float64
    A = torch.cat([Jc, Jp, e[:, :, None]], dim=2).to(f64)     # [E, 3, 10]
    wd = w.to(f64)
    out = torch.zeros((A.shape[0], 72), dtype=torch.float32)
    for lane in bs.gn_lane_plan():
        for word in lane:
            if word < 0:
                continue
            q, p, first, second, neg = bs.plan_entry(word)
            acc = (wd * A[:, 0, q]) * A[:, 0, p]
            acc = acc + (wd * A[:, 1, q]) * A[:, 1, p]
            acc = acc + (wd * A[:, 2, q]) * A[:, 2, p]
            v = (-acc if neg else acc).to(torch.float32)
            out[:, first] = v
            if second != bs.NONE:
                out[:, second] = v
    return out


def _static_case(rng, E, C=6, P=80):
    from test_torch_ba_kernels import _static_problem
    case = list(_static_problem(rng, C=C, P=P, E=E))
    if E > 6:
        case[5][5] = [np.inf, 1.0, 1.0]        # rho inf
        case[5][6] = [np.nan, 1.0, 1.0]        # rho NaN
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in case]


@pytest.mark.parametrize("huber", [True, False])
def test_gn_lane_plan_gives_the_plain_rows_bit_for_bit(huber):
    """The plan's entries, each the kernel's three float64 products and
    sums, with the symmetric half copied, are static_edges_ref's rows."""
    rng = np.random.default_rng(31 + huber)
    R, t, pts, e_cam, e_pt, obs, info, active = _static_case(rng, 700)
    cam = (458.654, 457.296, 367.215, 248.375, 50.0)
    rows = bs.static_edges_ref(R, t, pts, e_cam, e_pt, obs, info, active,
                               cam, 0.7, huber, bs.ROWS)
    e, Jc, Jp, _, stereo = bs.project_ref(R[e_cam.long()], t[e_cam.long()],
                                          pts[e_pt.long()], obs, cam)
    chi2 = bs.sqnorm3(e) * info * 0.7
    delta = torch.where(stereo, bs.DELTA_STEREO, bs.DELTA_MONO) \
        .to(torch.float32)
    wh, _ = bs.huber_ref(chi2, delta, huber)
    base = info * 0.7
    w = (base if wh is None else base * wh) * active
    got = _plan_rows(Jc, Jp, e, w)
    want = torch.cat([rows.cam, rows.pt, rows.pc], dim=1)
    same = (got.view(torch.int32) == want.view(torch.int32)) | \
        (torch.isnan(got) & torch.isnan(want))
    assert bool(same.all())


def _cluster_sum(terms):
    """csrc/ba_static.cu static_cost_sum_kernel's order: per chunk of 8192
    terms, the thread of partial j (in block j // 128 of the cluster) adds
    the chunk's terms j, j + 1024, ..., j + 7168 to it, then the halving
    tree over the 1024 partials."""
    chunk = 8 * lc.PARTIALS
    n = terms.shape[0]
    padded = torch.cat([terms, terms.new_zeros(-(-n // chunk) * chunk - n)])
    acc = terms.new_zeros(lc.PARTIALS)
    for c in range(padded.shape[0] // chunk):
        block = padded[c * chunk:(c + 1) * chunk].reshape(8, lc.PARTIALS)
        for r in range(8):
            acc = acc + block[r]
    half = lc.PARTIALS // 2
    while half:
        acc = acc[:half] + acc[half:2 * half]
        half //= 2
    return acc[0]


@pytest.mark.parametrize("E", [0, 1, 1023, 1025, 8192, 40960])
def test_static_edge_cost_sum_is_lm_cost_of_the_cost_mode(E):
    """The fused cost's plain version is lm_cost of the cost mode's rho,
    bit for bit (with an infinite and a NaN rho), and the kernel's order
    (chunks of 8192 terms into the leader's 1024 partials) gives the same
    bits."""
    rng = np.random.default_rng(E)
    args = _static_case(rng, E, C=12, P=400)
    cam = (458.654, 457.296, 367.215, 248.375, 50.0)
    for huber in (True, False):
        got = bs.static_edge_cost_sum(*args, cam, 1.0, huber)
        cost = bs.static_edge_cost(*args[:7], cam, 1.0, huber)
        want = lc.lm_cost_ref(cost.rho, args[7])
        assert got.dim() == 0 and got.dtype == torch.float32
        assert got.view(torch.int32) == want.view(torch.int32), (got, want)
        terms = torch.where(torch.isfinite(cost.rho), cost.rho,
                            torch.full_like(cost.rho, lc.NON_FINITE)) * args[7]
        assert _cluster_sum(terms).view(torch.int32) == got.view(torch.int32)
    if E > 6:
        assert not torch.isfinite(cost.rho[5]) and torch.isnan(cost.rho[6])


# ------------------------------------------- fast_nms and pyramid levels

# an image's level shapes: 360x640 x 8 (the bench budget), long-110's
# 240x320 x 4, the small camera's 240x320 x 4 at 600 features and a
# 120x160 x 4 test frame, 16 levels, levels under one tile a side, and a
# single level of one pixel
LEVEL_SHAPES = {
    "360x640 x 8": pk.level_shapes(360, 640, 8, 1.2),
    "240x320 x 4": pk.level_shapes(240, 320, 4, 1.2),
    "120x160 x 4": pk.level_shapes(120, 160, 4, 1.2),
    "16 levels": pk.level_shapes(400, 700, 16, 1.2),
    "under a tile": pk.level_shapes(44, 60, 3, 1.2),
    "one pixel": [(1, 1)],
}


def _cover(shapes, tiles):
    """How many times each pixel of each level lies in one of `tiles`
    [(level, y0, x0)]."""
    seen = [np.zeros(s, np.int64) for s in shapes]
    for lvl, y0, x0 in tiles:
        h, w = shapes[lvl]
        assert 0 <= y0 < h and 0 <= x0 < w
        seen[lvl][y0:y0 + fk.TILE, x0:x0 + fk.TILE] += 1
    return seen


@pytest.mark.parametrize("case", LEVEL_SHAPES)
def test_fast_level_table_puts_every_pixel_in_one_block(case):
    """Block b computes the tile block_tile finds from the level table's
    first tiles: the blocks of level l are the consecutive first[l] ..
    first[l + 1] - 1, and every output pixel of every level lies in
    exactly one block's tile."""
    shapes = LEVEL_SHAPES[case]
    first, tiles_x = fk.level_table(shapes)
    assert len(first) == len(shapes) + 1 <= fk.MAX_LEVELS + 1
    assert first[-1] == sum(pk.tiles(h, w) for h, w in shapes)
    tiles = [fk.block_tile(b, first, tiles_x) for b in range(first[-1])]
    for b, (lvl, _, _) in enumerate(tiles):
        assert first[lvl] <= b < first[lvl + 1]
    assert all((c == 1).all() for c in _cover(shapes, tiles))


def test_fast_level_table_passes_over_a_level_without_tiles():
    shapes = [(64, 64), (0, 40), (40, 0), (33, 33)]
    first, tiles_x = fk.level_table(shapes)
    assert first == [0, 4, 4, 4, 8]
    assert [fk.block_tile(b, first, tiles_x)[0] for b in range(8)] == \
        [0] * 4 + [3] * 4


@pytest.mark.parametrize("per_sm", (1, 4, 8))
@pytest.mark.parametrize("case", LEVEL_SHAPES)
def test_pyramid_phase_plan_puts_every_pixel_in_one_tile(case, per_sm):
    """In each phase of the cooperative launch the blocks' grid-stride
    tiles cover every pixel of that level once; the grid is no larger
    than level 0's tiles, BLOCKS_PER_SM blocks an SM or what is resident
    at once; a grid barrier between phases."""
    shapes = LEVEL_SHAPES[case]
    sms = 132
    grid = pk.launch_grid(shapes, sms, per_sm)
    assert 1 <= grid <= min(pk.tiles(*shapes[0]),
                            pk.BLOCKS_PER_SM * sms, per_sm * sms)
    plan = pk.phase_plan(shapes, grid)
    assert len(plan) == len(shapes)          # len(shapes) - 1 barriers
    for lvl, blocks in enumerate(plan):
        assert len(blocks) == grid
        tiles = [(lvl, y0, x0) for b in blocks for y0, x0 in b]
        assert len(tiles) == pk.tiles(*shapes[lvl])
        assert (_cover(shapes, tiles)[lvl] == 1).all()
        # a block's tiles of a phase differ in count by at most one
        assert max(map(len, blocks)) - min(map(len, blocks)) <= 1


def test_pyramid_grid_at_the_bench_shape():
    """360x640: level 0's 240 tiles, one tile a block a phase on an H100's
    132 SMs at two blocks an SM."""
    shapes = LEVEL_SHAPES["360x640 x 8"]
    assert pk.tiles(*shapes[0]) == 240
    assert pk.launch_grid(shapes, 132, 4) == 240
    assert pk.launch_grid(shapes, 132, 1) == 132
    assert [pk.tiles(*s) for s in shapes] == [240, 170, 112, 84, 60, 45,
                                              28, 24]
    assert fk.level_table(shapes)[0][-1] == 763


@pytest.mark.parametrize("case", LEVEL_SHAPES)
def test_level_views_are_aligned_and_disjoint(case):
    shapes = LEVEL_SHAPES[case]
    offsets, total = cuda_build.level_offsets(shapes)
    views = cuda_build.level_views(shapes, "cpu")
    ends = [o + h * w for o, (h, w) in zip(offsets, shapes)]
    assert all(o % cuda_build.LEVEL_ALIGN == 0 for o in offsets)
    assert all(e <= o for e, o in zip(ends, offsets[1:] + [total]))
    for v, o, s in zip(views, offsets, shapes):
        assert v.shape == s and v.is_contiguous()
        assert v.storage_offset() == o


def test_level_kernel_constants_are_the_wrappers():
    import re
    from pathlib import Path
    csrc = Path(cuda_build.CSRC)
    for name, module in (("fast.cu", fk), ("pyramid.cu", pk)):
        consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);",
                                 (csrc / name).read_text()))
        assert int(consts["kMaxLevels"]) == module.MAX_LEVELS == 16
        assert int(consts["kTile"]) == module.TILE == 32


# (P, C): the paths' shapes (local BA, long-110, crowd-27, the dry run),
# then C 1, odd C and odd P C, P below one block and C 70 / 128
LANDMARK_SHAPES = ((2048, 24), (1024, 24), (2048, 48), (32, 4), (2048, 1),
                   (171, 1), (1, 1), (173, 7), (999, 3), (5, 3), (3, 2),
                   (37, 70), (4096, 128), (1, 128))


def _reduce_threads(P, C):
    """Every thread of the reduce launch: block and thread indices, first
    row and rows (numpy arrays, one entry a thread)."""
    b, t = np.meshgrid(np.arange(bp.reduce_blocks(P, C)),
                       np.arange(bp.REDUCE_THREADS), indexing="ij")
    first, count = bp.reduce_thread_rows(b, t, P, C)
    return b.ravel(), t.ravel(), first.ravel(), count.ravel()


@pytest.mark.parametrize("P,C", LANDMARK_SHAPES)
def test_landmark_reduce_plan_puts_every_row_in_one_thread(P, C):
    """Every one of Wagg's P 6 C rows in exactly one thread; the kernel's
    point of each row is the row's; each block's point range covers its
    threads' rows and fits its shared memory."""
    b, _, first, count = _reduce_threads(P, C)
    seen = np.zeros(P * 6 * C, np.int64)
    lo, n = bp.reduce_block_points(np.arange(bp.reduce_blocks(P, C)), P, C)
    assert lo[0] == 0 and lo[-1] + n[-1] == P
    assert (1 <= n).all() and (n <= bp.MAX_BLOCK_POINTS).all()
    for i, pts in enumerate(bp.reduce_row_points(first, C)):
        has = count > i
        rows = (first + i)[has]
        np.add.at(seen, rows, 1)
        assert np.array_equal(pts[has], rows // (6 * C))
        blk = b[has]
        assert (pts[has] >= lo[blk]).all()
        assert (pts[has] < lo[blk] + n[blk]).all()
    assert (seen == 1).all()


@pytest.mark.parametrize("P,C", LANDMARK_SHAPES)
def test_landmark_reduce_plan_writes_every_inverse_once(P, C):
    """Each block writes the inverses of its points whose first row is
    not before its own first row: every point's exactly once, by the
    block hinv_block names; a point is inverted by every block its rows
    reach."""
    blocks = bp.reduce_blocks(P, C)
    writes = np.zeros(P, np.int64)
    inverted = np.zeros(P, np.int64)
    for blk in range(blocks):
        lo, n = bp.reduce_block_points(blk, P, C)
        pts = np.arange(lo, lo + n)
        mine = pts[pts * 6 * C >= blk * bp.ROWS_A_BLOCK]
        writes[mine] += 1
        inverted[pts] += 1
        assert (bp.hinv_block(mine, C) == blk).all()
    assert (writes == 1).all()
    first_rows = np.arange(P) * 6 * C
    last_rows = first_rows + 6 * C - 1
    assert np.array_equal(inverted, last_rows // bp.ROWS_A_BLOCK
                          - first_rows // bp.ROWS_A_BLOCK + 1)


@pytest.mark.parametrize("C", (1, 3, 4, 24, 32, 33, 48, 70, 128))
def test_landmark_backsub_passes_give_each_lane_its_cameras(C):
    """The kernel's passes (cameras c0 .. c0 + 31, lane j camera c0 + j)
    give lane j the cameras j, j + 32, ... in that order, which
    landmark_backsub_ref sums; every camera in one lane."""
    passes = [(c0, min(bp.LANES, C - c0)) for c0 in range(0, C, bp.LANES)]
    seen = []
    for lane in range(bp.LANES):
        got = [c0 + lane for c0, cams in passes if lane < cams]
        assert got == bp.backsub_lane_cameras(C, lane) \
            == list(range(lane, C, bp.LANES))
        seen += got
    assert sorted(seen) == list(range(C))


@pytest.mark.parametrize("P", (1, 7, 8, 9, 1024, 2048, 2049))
def test_landmark_backsub_blocks_take_every_point_once(P):
    pts = [blk * bp.BACKSUB_WARPS + w for blk in range(bp.backsub_blocks(P))
           for w in range(bp.BACKSUB_WARPS)]
    assert [p for p in pts if p < P] == list(range(P))
    assert len(pts) - P < bp.BACKSUB_WARPS


def test_landmark_wagg_is_handed_over_on_16_bytes():
    """The wrappers pass Wagg as it is where it starts on 16 bytes, else a
    copy that does (the kernels' vector loads)."""
    buf = torch.arange(40, dtype=torch.float32)
    for shift in range(4):
        x = buf[shift:shift + 36].view(2, 18)
        got = bp.aligned(x)
        assert got.data_ptr() % 16 == 0 and torch.equal(got, x)
        assert (got.data_ptr() == x.data_ptr()) == (x.data_ptr() % 16 == 0)


def test_landmark_kernel_constants_are_the_plans():
    import re
    from pathlib import Path
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);",
        (Path(cuda_build.CSRC) / "ba_points.cu").read_text())}
    assert consts["kReduceThreads"] == bp.REDUCE_THREADS == 256
    assert consts["kRowsAThread"] == bp.ROWS_A_THREAD == 4
    assert consts["kRowsABlock"] == bp.ROWS_A_BLOCK == 1024
    assert consts["kMaxPoints"] == bp.MAX_BLOCK_POINTS == 172
    assert consts["kBacksubWarps"] == bp.BACKSUB_WARPS == 8
    assert consts["kLanes"] == bp.LANES == 32
    # the most points a block touches is reached at C = 1
    _, n = bp.reduce_block_points(np.arange(bp.reduce_blocks(2048, 1)),
                                  2048, 1)
    assert n.max() == bp.MAX_BLOCK_POINTS
    # the paths' shapes: one wave of blocks on an H100's 132 SMs at 8
    # resident blocks an SM
    assert [bp.reduce_blocks(P, C) for P, C in
            ((2048, 24), (1024, 24), (2048, 48), (32, 4))] == \
        [288, 144, 576, 1]
    assert bp.backsub_blocks(2048) == 256


# -------------------------------------------------- human_edge_blocks

@pytest.mark.parametrize("fam", [0, 1, 2])
def test_human_lane_plan_writes_every_entry_once(fam):
    """A family's plan words put each of an edge's Q Q + Q Gauss-Newton
    floats (81 + 9, 49 + 7, 144 + 12) in exactly one place, each lane at
    most SLOTS[fam] entries, the lanes' loads within one entry."""
    R, Q = bh.FAMILIES[fam]
    plan = bh.gn_lane_plan(fam)
    assert len(plan) == bh.LANES
    assert all(len(lane) == bh.SLOTS[fam] for lane in plan)
    written = np.zeros(Q * Q + Q, np.int64)
    per_lane = []
    for lane in plan:
        words = [w for w in lane if w >= 0]
        assert lane[len(words):] == [-1] * (bh.SLOTS[fam] - len(words))
        per_lane.append(len(words))
        for w in words:
            q, p, first, second, neg = bh.plan_entry(w)
            assert 0 <= q < Q and 0 <= p <= Q and neg == (p == Q)
            written[first] += 1
            if second != bh.NONE:
                written[second] += 1
    assert (written == 1).all()
    assert max(per_lane) - min(per_lane) <= 1
    assert sum(per_lane) == Q * (Q + 1) // 2 + Q


def test_human_kernel_constants_are_the_plans():
    import re
    from pathlib import Path
    text = (Path(cuda_build.CSRC) / "ba_human.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}
    assert consts["kLanes"] == bh.LANES
    assert consts["kNone"] == bh.NONE
    assert consts["kSumThreads"] == lc.PARTIALS
    fams = re.findall(r"static constexpr int R = (\d+), Q = (\d+), "
                      r"kSlots = (\d+)", text)
    assert [tuple(map(int, f)) for f in fams] == \
        [fam + (slots,) for fam, slots in zip(bh.FAMILIES, bh.SLOTS)]


def _human_case(rng, T, L, huber):
    from test_torch_ba_kernels import CAM, SIG, _human_problem, _t
    state, tb, act = _human_problem(rng, T=T, L=L)
    return (tuple(_t(x) for x in state), tb, [_t(a) for a in act], CAM, SIG,
            huber)


def _plan_column(fams, weights):
    """The Gauss-Newton column as csrc/ba_human.cu's lanes compute it from
    the plans: each entry's float64 products and sums over the rows of
    A = [J | e], one rounding, the symmetric half copied; every family's
    J^T w J, then every family's -J^T w e."""
    hs, bs_ = [], []
    for fam, (f, w) in enumerate(zip(fams, weights)):
        R, Q = bh.FAMILIES[fam]
        A = torch.cat([f.J, f.e[:, :, None]], dim=2).to(torch.float64)
        wd = w.to(torch.float64)
        out = torch.full((A.shape[0], Q * Q + Q), 3e38)
        for lane in bh.gn_lane_plan(fam):
            for word in lane:
                if word < 0:
                    continue
                q, p, first, second, neg = bh.plan_entry(word)
                acc = (wd * A[:, 0, q]) * A[:, 0, p]
                for r in range(1, R):
                    acc = acc + (wd * A[:, r, q]) * A[:, r, p]
                v = (-acc if neg else acc).to(torch.float32)
                out[:, first] = v
                if second != bh.NONE:
                    out[:, second] = v
        hs.append(out[:, :Q * Q].reshape(-1))
        bs_.append(out[:, Q * Q:].reshape(-1))
    return torch.cat(hs + bs_)


@pytest.mark.parametrize("case", ["huber", "no huber", "no motion edge",
                                  "offsets off 16 bytes"])
def test_human_lane_plan_gives_the_plain_column_bit_for_bit(case):
    """The plans' entries, each the kernel's float64 products and sums
    with the symmetric half copied, are human_edges_ref's column: with
    Huber on and off, with an empty motion family (one pose a
    trajectory), and at family sizes whose offsets in the column are not
    multiples of 4 floats (126 / 126 / 30 edges: 81 x 126 floats)."""
    T, L = {"no motion edge": (2, 1), "offsets off 16 bytes": (3, 3)}.get(
        case, (2, 4))
    state, tb, act, cam, sig, huber = _human_case(
        np.random.default_rng(41 + len(case)), T, L, case != "no huber")
    sizes = bh.family_sizes(tb)
    if case == "no motion edge":
        assert sizes[2] == 0
    if case == "offsets off 16 bytes":
        assert (81 * sizes[0]) % 4 and (9 * sizes[0]) % 4
    col = bh.human_edges_ref(*state, tb, act, cam, sig, huber, bh.ROWS)
    fams, _ = bh.human_families_ref(*state, tb, cam, sig, huber)
    got = _plan_column(fams, bh.family_weights(fams, sig, act))
    assert got.shape == col.shape == (bh.n_values(tb),)
    assert bool((got.view(torch.int32) == col.view(torch.int32)).all())


def _copy_out(phase, count, threads=128):
    """csrc/ba_human.cu copy_out's stores: (16-byte stores as the first
    float of each, single floats) of `count` floats whose first float sits
    at `phase` floats past a 16-byte boundary, over the block's threads."""
    head = min((4 - phase) & 3, count)
    n4 = (count - head) // 4
    tail = head + 4 * n4
    vec = [head + 4 * m for t in range(threads)
           for m in range(t, n4, threads)]
    one = [m if m < head else tail + m - head for t in range(threads)
           for m in range(t, head + count - tail, threads)]
    return vec, one


@pytest.mark.parametrize("phase", range(4))
def test_human_copy_out_writes_each_float_once_on_16_bytes(phase):
    """Every float of a block's slice once; each 16-byte store starts on
    16 bytes of the column (and so of the staging, which sits at the
    same phase)."""
    for count in (0, 1, 2, 3, 4, 5, 7, 9, 49, 90, 112, 1296, 2304):
        vec, one = _copy_out(phase, count)
        seen = np.zeros(count, np.int64)
        for at in vec:
            assert (phase + at) % 4 == 0
            seen[at:at + 4] += 1
        np.add.at(seen, one, 1)
        assert (seen == 1).all(), (phase, count)


def _lm_cost_order(terms):
    """csrc/ba_human.cu human_cost_sum_kernel's order for a family (that
    of ops/lm_cost.py): thread j adds the terms j, j + 1024, ... in
    sequence from 0, then the halving tree, in float32."""
    n = terms.shape[0]
    m = -(-n // 1024)
    rows = np.zeros(m * 1024, np.float32)
    rows[:n] = terms
    acc = np.zeros(1024, np.float32)
    for r in rows.reshape(max(m, 0), 1024):
        acc = (acc + r).astype(np.float32)
    half = 512
    while half:
        acc = (acc[:half] + acc[half:2 * half]).astype(np.float32)
        half //= 2
    return acc[0]


@pytest.mark.parametrize("n", [0, 1, 15, 280, 896, 1025, 5000])
def test_human_cost_sum_ref_is_three_lm_cost_sums(n):
    """The three families' LM costs of the cost-sum mode are lm_cost_ref
    of each family's rho and activity, bit for bit (with infinite and NaN
    rho among active and inactive edges), and the kernel's order gives
    the same bits."""
    rng = np.random.default_rng(n)
    sizes = (n, n // 3, max(n - 7, 0))
    rho = rng.exponential(3.0, sum(sizes)).astype(np.float32)
    rho[rng.random(rho.shape[0]) < 0.01] = np.inf
    rho[rng.random(rho.shape[0]) < 0.01] = np.nan
    act = [(rng.random(k) > 0.2).astype(np.float32) for k in sizes]
    got = bh.human_cost_sum_ref(torch.from_numpy(rho),
                                [torch.from_numpy(a) for a in act], sizes)
    assert got.shape == (3,) and got.dtype == torch.float32
    for f, (r, a) in enumerate(zip(np.split(rho, np.cumsum(sizes)[:2]),
                                   act)):
        want = lc.lm_cost_ref(torch.from_numpy(r), torch.from_numpy(a))
        assert got[f].view(torch.int32) == want.view(torch.int32)
        terms = np.where(np.isfinite(r), r, np.float32(lc.NON_FINITE)) * a
        assert np.float32(got[f]).view(np.int32) == \
            _lm_cost_order(terms.astype(np.float32)).view(np.int32)


@pytest.mark.parametrize("huber", [True, False])
def test_human_edge_cost_sum_is_lm_cost_of_the_cost_mode(huber):
    state, tb, act, cam, sig, huber = _human_case(
        np.random.default_rng(7), 2, 4, huber)
    got = bh.human_edge_cost_sum(*state, tb, act, cam, sig, huber)
    rho = bh.human_edge_cost(*state, tb, cam, sig, huber).rho
    want = torch.stack([lc.lm_cost_ref(r, a) for r, a in
                        zip(rho.split(list(bh.family_sizes(tb))), act)])
    assert bool((got.view(torch.int32) == want.view(torch.int32)).all())


def test_human_bundle_adjust_with_the_cost_sum_is_bit_for_bit_the_lm_costs(
        monkeypatch):
    """A human BA solve on the CPU with the three families' costs summed
    in the cost-sum mode gives the state of the same solve with each
    family's cost mode rho summed by lm_cost, bit for bit."""
    import airdos_tpu_torch.solvers.human_ba as thba
    from test_torch_human import _ba_case, _run_port
    pr = _ba_case("bad joint")[0]
    fused = _run_port(pr)

    def three_lm_costs(camR, camt, jnts, segs, mR, mt, tables, act, cam,
                       sig, use_huber):
        rho = thba.human_edge_cost(camR, camt, jnts, segs, mR, mt, tables,
                                   cam, sig, use_huber).rho
        return [lc.lm_cost_ref(r, a) for r, a in
                zip(rho.split(list(bh.family_sizes(tables))), act)]
    monkeypatch.setattr(thba, "human_edge_cost_sum", three_lm_costs)
    apart = _run_port(pr)
    for name, a, b in zip(fused._fields, fused, apart):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype == torch.bool:
            assert torch.equal(a, b), name
        else:
            assert bool((a.view(torch.int32) == b.view(torch.int32)).all()), \
                name


def test_launch_tables_raise_on_cpu_tensors():
    state, tb, act, cam, sig, huber = _human_case(
        np.random.default_rng(3), 2, 2, True)
    with pytest.raises(ValueError):
        bh.launch_tables(tb)
    with pytest.raises(ValueError):
        bh.human_edges_cuda(*state, tb, act, cam, sig, huber, bh.COST_SUM)
    assert bh.tables_of(tb) is tb and bh.family_sizes(tb) == (56, 56, 10)
