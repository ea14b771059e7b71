"""The port's segment ops against graph_tpu's, on the same numpy inputs.

The fixed-point sums (``segment_sum_fixedpoint``, ``segment_sum_quanta``)
and the mins and maxes must match bit for bit, wraparound and the fills
of empty segments included.  The f32 sums add in an order each library
chooses: ``segment_sum_sorted`` is held to 1e-6 relative, and
``segment_sum_cumsum`` (differences of f32 prefixes) to 1e-6 of the
stream's total magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_tpu.ops import segment as jseg
from graph_tpu_torch.ops import segment as tseg


def _segments(seed, num_segments=300, m=5000):
    """Ascending segment ids with empty segments (every third id unused,
    and the last ten), and the CSR offsets of the same segments."""
    g = np.random.default_rng(seed)
    ids = np.sort(g.integers(0, num_segments - 10, m))
    ids = ids[ids % 3 != 1]
    offsets = np.searchsorted(ids, np.arange(num_segments + 1))
    return ids.astype(np.int32), offsets.astype(np.int32)


def _both(fn_name, *arrays, **kw):
    want = getattr(jseg, fn_name)(*[jnp.asarray(a) if isinstance(
        a, np.ndarray) else a for a in arrays], **kw)
    got = getattr(tseg, fn_name)(*[torch.from_numpy(a) if isinstance(
        a, np.ndarray) else a for a in arrays], **kw)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("bound", [1.0, 3.0])
def test_fixedpoint_sums_bit_exact(seed, bound):
    ids, offsets = _segments(seed)
    x = (np.random.default_rng(seed + 10).random(ids.size) * 1e-2
         ).astype(np.float32)
    for name in ("segment_sum_fixedpoint", "segment_sum_quanta"):
        want, got = _both(name, x, offsets, bound=bound)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_fixedpoint_sums_wrap_like_int32():
    """Segment sums of 2**30-quanta above 2 wrap mod 2**32, and the
    prefix sums themselves pass 2**31 many times."""
    ids, offsets = _segments(3, num_segments=40, m=4000)
    x = np.full(ids.size, 1.9, np.float32)
    x[::2] = -1.7
    x[::7] = 1.999
    want, got = _both("segment_sum_quanta", x, offsets)
    np.testing.assert_array_equal(got, want)
    q = np.round(x.astype(np.float64) * 2**30).astype(np.int64)
    exact = np.add.reduceat(np.concatenate([q, [0]]), offsets[:-1])
    exact[offsets[:-1] == offsets[1:]] = 0
    assert (np.abs(exact) >= 2**31).any(), "some segment must wrap"
    np.testing.assert_array_equal(got, exact.astype(np.int32))
    want, got = _both("segment_sum_fixedpoint", x, offsets)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("op", ["segment_min_sorted", "segment_max_sorted"])
def test_min_max_with_empty_fills(dtype, op):
    ids, offsets = _segments(5)
    g = np.random.default_rng(6)
    if dtype == np.float32:
        x = (g.random(ids.size) * 200 - 100).astype(dtype)
    else:
        x = g.integers(-2**31, 2**31, ids.size).astype(dtype)
    want, got = _both(op, x, ids, 300)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    empty = offsets[:-1] == offsets[1:]
    assert empty.any()
    if dtype == np.float32:
        fill = np.inf if op == "segment_min_sorted" else -np.inf
    else:
        info = np.iinfo(dtype)
        fill = info.max if op == "segment_min_sorted" else info.min
    assert (got[empty] == fill).all()


def test_f32_sums_within_rounding():
    ids, offsets = _segments(7)
    x = np.random.default_rng(8).random(ids.size).astype(np.float32)
    want, got = _both("segment_sum_sorted", x, ids, 300)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    want, got = _both("segment_sum_cumsum", x, offsets)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * x.sum())


@pytest.mark.requires_cuda
def test_segment_ops_on_card_equal_cpu():
    """On a card: the fixed-point sums and the mins equal the CPU's bit
    for bit; the f32 index_add_ sums agree to 1e-6 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ids, offsets = _segments(9)
    x = np.random.default_rng(9).random(ids.size).astype(np.float32)
    cpu = [torch.from_numpy(a) for a in (x, ids, offsets)]
    card = [t.cuda() for t in cpu]
    for fn in (tseg.segment_sum_fixedpoint, tseg.segment_sum_quanta):
        assert torch.equal(fn(card[0], card[2]).cpu(), fn(cpu[0], cpu[2]))
    for fn in (tseg.segment_min_sorted, tseg.segment_max_sorted):
        assert torch.equal(fn(card[0], card[1], 300).cpu(),
                           fn(cpu[0], cpu[1], 300))
    np.testing.assert_allclose(
        tseg.segment_sum_sorted(card[0], card[1], 300).cpu().numpy(),
        tseg.segment_sum_sorted(cpu[0], cpu[1], 300).numpy(), rtol=1e-6)
