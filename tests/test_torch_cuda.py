"""Tests of the port that need an NVIDIA card (marker ``cuda``).

They skip where torch sees no CUDA device.  On a machine with a card and
no JAX, run them without the repository's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import airdos_tpu_torch.ops.hamming_kernels as hk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,m", [(1, 1), (63, 65), (1536, 1536), (2048, 1337)])
def test_hamming_kernel_equals_plain_version(cuda, n, m):
    rng = np.random.default_rng(n * 7919 + m)
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint64).astype(np.uint32)
    ta = torch.from_numpy(a.view(np.int32)).to(cuda)
    tb = torch.from_numpy(b.view(np.int32)).to(cuda)
    before = hk.launches()
    got = hk.hamming_matrix(ta, tb)
    torch.cuda.synchronize()
    assert hk.launches() == before + 1
    assert torch.equal(got, hk.hamming_matrix_ref(ta, tb))
    assert torch.equal(got.cpu(), hk.hamming_matrix_ref(ta.cpu(), tb.cpu()))


def test_hamming_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.zeros((4, 8), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        hk.hamming_matrix(a, a)
    with pytest.raises(ValueError):
        hk.hamming_matrix(a.to(torch.int32)[:, :4], a.to(torch.int32)[:, :4])
