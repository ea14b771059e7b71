"""K1 and K2 against their plain versions, on the card.

These need a CUDA device (a CUDA kernel has no CPU mode) and skip
without one.  The file imports neither JAX nor graph_tpu, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from graph_tpu_torch.engine.kernels import (
    LAUNCHES, k1_gather, k1_gather_plain, k2_reduce, k2_reduce_plain)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _cases(seed=13):
    """Empty rows, a hub row longer than a block, sums that wrap int32,
    and m not a multiple of the block size."""
    g = np.random.default_rng(seed)
    counts = g.integers(0, 40, 3001)
    counts[::5] = 0
    counts[17] = 300_001
    indptr = np.concatenate([[0], np.cumsum(counts)])
    m = int(indptr[-1])
    contrib = g.integers(-2**31, 2**31, m).astype(np.int32)
    xq = g.integers(-2**31, 2**31, 1 << 12).astype(np.int32)
    slot_src = g.integers(0, xq.size, m).astype(np.int32)
    return xq, slot_src, contrib, indptr


@pytest.mark.requires_cuda
def test_kernels_match_plain_on_card(cuda_device):
    xq, slot_src, contrib, indptr = (
        torch.from_numpy(a).to(cuda_device) for a in _cases())
    assert slot_src.numel() % 256 != 0
    before = dict(LAUNCHES)
    assert torch.equal(k1_gather(xq, slot_src), k1_gather_plain(xq, slot_src))
    assert torch.equal(k2_reduce(contrib, indptr),
                       k2_reduce_plain(contrib, indptr))
    one = torch.ones(1, dtype=torch.int32, device=cuda_device)
    assert torch.equal(k1_gather(xq, one), xq[1:2])
    torch.cuda.synchronize()
    assert LAUNCHES["k1_gather"] == before["k1_gather"] + 2
    assert LAUNCHES["k2_reduce"] == before["k2_reduce"] + 1


@pytest.mark.requires_cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    xq, slot_src, contrib, indptr = (
        torch.from_numpy(a).to(cuda_device) for a in _cases(seed=3))
    with pytest.raises(TypeError):
        k1_gather(xq.long(), slot_src)
    with pytest.raises(ValueError):
        k1_gather(xq, slot_src[::2])
    with pytest.raises(ValueError):
        k2_reduce(contrib, indptr.cpu())
    with pytest.raises(TypeError):
        k2_reduce(contrib, indptr.int())
