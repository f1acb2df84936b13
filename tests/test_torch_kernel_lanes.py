"""The lanes of csrc/voc_transform.cu and csrc/ransac.cu's epnp_kernel as
threads: each source compiled for the host with
tests/torch_kernel_host.py's threaded shim (a block's threads as
std::threads, warps of 32 lanes, barriers for the warp's and the
block's barriers, shuffles and votes through slots), so that the lanes'
split of the work, their shuffles and their barriers run as the card
runs them, and held against the plain versions:

- voc_transform: groups of 2-16 lanes a descriptor (k 3, 5, 8, 10, 16),
  with no node, a few and the wrapper's count staged in shared memory,
  bit-equal to voc_transform_ref;
- epnp_kernel: four warps a block over the hypotheses (samples drawn
  with repeats, as the SLAM draws them), then one warp for the refine:
  degenerate rows NaN with no inliers, poses within 1e-5 of
  epnp_hypotheses_ref / epnp_refine_ref in float64 with canonical=True,
  counts and the refine's inlier flags equal, two runs bit-equal.
"""
import ctypes
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import airdos_tpu_torch.ops.ransac_kernels as rk
import airdos_tpu_torch.ops.voc_kernels as vk
from airdos_tpu_torch.bow.vocabulary import Vocabulary
from airdos_tpu_torch.convert import desc_to_tensor
from airdos_tpu_torch.solvers import epnp as ep

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_kernel_host as kh  # noqa: E402
import torch_ransac_cases as trc  # noqa: E402
from test_torch_ops import one_torch_thread  # noqa: E402,F401 (autouse)

CAM = (trc.FX, trc.FY, trc.CX, trc.CY)


@pytest.fixture(scope="module")
def lanes_voc(tmp_path_factory):
    glue = """
extern "C" void lanes_voc(const VocParams* p, int G) {
  const long long per = 128 / G;
  for (long long b = 0; b * per < p->n; ++b) {
    blockIdx.x = b;
    run_block(128, [&] {
      switch (G) {
        case 2: voc_transform_kernel<2>(*p); break;
        case 4: voc_transform_kernel<4>(*p); break;
        case 8: voc_transform_kernel<8>(*p); break;
        default: voc_transform_kernel<16>(*p);
      }
    });
  }
}
"""
    lib = kh.build("voc_transform.cu", glue, tmp_path_factory.mktemp("vl"),
                   threaded=True)
    lib.lanes_voc.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


@pytest.fixture(scope="module")
def lanes_epnp(tmp_path_factory):
    glue = """
extern "C" void lanes_epnp(const RansacParams* p) {
  const long long per = p->refine ? 1 : 4;
  for (long long b = 0; b * per < p->n_hyp; ++b) {
    blockIdx.x = b;
    run_block(32 * per, [&] { epnp_kernel(*p); });
  }
}
"""
    lib = kh.build("ransac.cu", glue, tmp_path_factory.mktemp("el"),
                   threaded=True)
    lib.lanes_epnp.argtypes = [ctypes.c_void_p]
    return lib


@pytest.mark.parametrize("k", [3, 5, 8, 10, 16])
def test_voc_transform_lanes_are_bit_equal(lanes_voc, k):
    children, desc, word_id = trc.full_tree(30 + k, k, 3)
    children[2, k // 2:] = -1                 # a node with fewer children
    desc[k + 1:2 * k + 1] = desc[k + 1]       # siblings at a tie
    q = np.concatenate([trc.words(31 + k, 150), desc[k + 1:k + 2]])
    n_words = int((word_id >= 0).sum())
    voc = Vocabulary(k=k, depth=3, node_desc32=desc, children=children,
                     word_id=word_id, weights=np.ones(n_words, np.float32),
                     n_words=n_words, feature_level=1, device="cpu")
    tables = voc._device_tables()
    d = desc_to_tensor(q, "cpu")
    want = vk.voc_transform_ref(*tables, d, 3)
    group = 1 << (k - 1).bit_length()
    n = d.shape[0]
    for staged in (0, 7, vk.staged_nodes(len(word_id), k)):
        out = torch.empty((2, n), dtype=torch.int32)
        block = ctypes.create_string_buffer(vk._PARAMS.pack(
            n, k, 3, staged, *(t.data_ptr() for t in tables), d.data_ptr(),
            out.data_ptr(), out.data_ptr() + 4 * n))
        lanes_voc.lanes_voc(ctypes.addressof(block), group)
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


def _ptr(x):
    return 0 if x is None else x.data_ptr()


def _run(lib, n, H, refine, pw, uv, valid, gate, smp, Rb=None, tb=None,
         ib=None):
    R, t = torch.empty(H, 3, 3), torch.empty(H, 3)
    inl = torch.empty(H, n, dtype=torch.bool)
    cnt = torch.empty(H, dtype=torch.int64)
    block = ctypes.create_string_buffer(rk._PARAMS.pack(
        n, H, int(refine), 1, *(_ptr(x) for x in (
            pw, uv, valid, gate, gate, smp, Rb, tb, None, ib, R, t, None,
            inl, cnt)), *CAM))
    lib.lanes_epnp(ctypes.addressof(block))
    return R, t, inl, cnt


@pytest.mark.parametrize("seed,n,H", [(5, 120, 40), (3, 483, 21)])
def test_epnp_lanes_match_the_plain_version(lanes_epnp, seed, n, H):
    pw, uv, valid, gate, smp = (torch.from_numpy(np.array(a)) for a in
                                trc.pnp_case(seed, n=n, n_out=n // 5, H=H,
                                             distinct=False))
    got = _run(lanes_epnp, n, H, False, pw, uv, valid, gate, smp)
    again = _run(lanes_epnp, n, H, False, pw, uv, valid, gate, smp)
    want = ep.epnp_hypotheses_ref(pw.double(), uv.double(), valid,
                                  gate.double(), smp, *CAM, canonical=True)
    bad = rk.repeats(smp.long())
    assert torch.isnan(got[0][bad]).all() and (got[3][bad] == 0).all()
    gap = (rk.pose_rows(got) - rk.pose_rows(want))[~bad].abs().amax(1)
    assert float(gap.max()) < 1e-5
    assert torch.equal(got[3], want[3])
    for a, b in zip(got, again):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0)) \
            if a.is_floating_point() else torch.equal(a, b)
    best = int(torch.argmax(got[3]))
    Rb, tb, ib = (x[best].contiguous() for x in got[:3])
    r = _run(lanes_epnp, n, 1, True, pw, uv, valid, gate, None, Rb, tb, ib)
    w = ep.epnp_refine_ref(pw.double(), uv.double(), valid, gate.double(),
                           Rb.double(), tb.double(), ib, *CAM, canonical=True)
    assert float((r[0][0] - w[0]).abs().max()) < 1e-5
    assert float((r[1][0] - w[1]).abs().max()) < 1e-5
    assert torch.equal(r[2][0], w[2]) and int(r[3][0]) == int(w[3])
