"""The K1 gather probes of graph_tpu_torch against the TPU kernels of
``scripts/perf_k1_{lanemap,rowmatch,sublane}.py``, run in interpret mode.

Each case runs the script's own kernel through ``pl.pallas_call(...,
interpret=True)`` with the script's BlockSpecs on two blocks: the first
holds the script's own input (the port's builder, one block), the second
arbitrary in-range input.  The port's plain version must give the same
bits on every slot.  The scripts are not a package: they are loaded by
file path.
"""

import functools
import importlib.util
import inspect
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from graph_tpu_torch.probes import BLK, TPB, k1_lanemap, k1_rowmatch
from graph_tpu_torch.probes import k1_sublane, kernels

ROOT = Path(__file__).resolve().parents[1]
ROWS = BLK // 128
WINDOWS = (1024, 2048, 8192)  # one group, then the group select


@functools.lru_cache(maxsize=None)
def _script(name):
    path = ROOT / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def depth_kernel(rows):
    """Verbatim copy of ``depth_probe``'s kernel, a closure in
    ``scripts/perf_k1_lanemap.py:28-34`` (checked below)."""
    def kernel(r_ref, t_ref, out_ref, rows=rows):
        def body(t, _):
            idx = r_ref[pl.ds(t * 8, 8), :].astype(jnp.int32)
            out_ref[pl.ds(t * 8, 8), :] = jnp.take_along_axis(
                t_ref[0:rows, :], idx % rows, axis=0)[0:8]
            return 0
        jax.lax.fori_loop(0, TPB, body, 0, unroll=True)
    return kernel


def _tpu(kernel, table_block, idx, table):
    """The script's pallas_call over ``idx``'s blocks, in interpret mode."""
    nblk = idx.shape[0] // ROWS
    f = pl.pallas_call(
        kernel, grid=(nblk,),
        in_specs=[pl.BlockSpec((ROWS, 128), lambda k: (k, 0)),
                  pl.BlockSpec(table_block, lambda k: (0,) * len(
                      table_block))],
        out_specs=pl.BlockSpec((ROWS, 128), lambda k: (k, 0)),
        out_shape=jax.ShapeDtypeStruct((nblk * ROWS, 128), jnp.float32),
        interpret=True)
    return np.asarray(f(jnp.asarray(idx), jnp.asarray(table)))


def _two_blocks(script_idx, arbitrary_idx):
    return np.concatenate([script_idx, arbitrary_idx]).astype(np.uint16)


@functools.lru_cache(maxsize=None)
def _depth_case(rows):
    ridx, t = k1_lanemap.depth_input(rows, nblk=1)
    g = np.random.default_rng(100 + rows)
    idx = _two_blocks(ridx, g.integers(0, 1 << 16, (ROWS, 128)))
    return idx, t, _tpu(depth_kernel(rows), (rows, 128), idx, t)


@functools.lru_cache(maxsize=None)
def _lanemap_case(win):
    st, x = k1_lanemap.lanemap_input(win, nblk=1)
    g = np.random.default_rng(200 + win)
    # any in-range stream: A < win/128, any lo, bits 7 and 15 set at random
    a = g.integers(0, win // 128, (ROWS, 128))
    free = g.integers(0, 2, (ROWS, 128)) * 128 + g.integers(
        0, 2, (ROWS, 128)) * 32768
    idx = _two_blocks(st, g.integers(0, 128, (ROWS, 128)) | (a << 8) | free)
    mk = _script("perf_k1_lanemap").make_lanemap
    return idx, x, _tpu(mk(win), (win,), idx, x)


@functools.lru_cache(maxsize=None)
def _window_case(script, win, mode):
    inputs = (k1_rowmatch.rowmatch_inputs if script == "perf_k1_rowmatch"
              else k1_sublane.sublane_inputs)
    _, sidx, x = next(c for c in inputs(WINDOWS, nblk=1) if c[0] == win)
    g = np.random.default_rng(300 + win)
    idx = _two_blocks(sidx, g.integers(0, win, (ROWS, 128)))
    mk = _script(script).make_kernel
    return idx, x, _tpu(mk(win, mode), (win,), idx, x)


def _plain(fn, idx, table, *args):
    return fn(torch.from_numpy(idx), torch.from_numpy(table), *args).numpy()


def _x_idx_share(out, idx, x):
    return float((out == x[idx.astype(np.int64)]).mean())


def test_depth_kernel_copy_is_verbatim():
    lines = (ROOT / "scripts" / "perf_k1_lanemap.py").read_text().splitlines(
        keepends=True)
    want = textwrap.dedent("".join(lines[27:34]))
    assert want.startswith("def kernel(r_ref, t_ref, out_ref, rows=rows):")
    assert textwrap.dedent(inspect.getsource(depth_kernel(8))) == want


@pytest.mark.parametrize("rows", k1_lanemap.ROWS)
def test_row_gather_plain_equals_tpu_depth_probe(rows):
    idx, t, want = _depth_case(rows)
    assert idx[ROWS:].max() >= rows  # the mod is exercised
    np.testing.assert_array_equal(_plain(kernels.row_gather_plain, idx, t),
                                  want)


@pytest.mark.parametrize("win", k1_lanemap.WINDOWS)
def test_lanemap_plain_equals_tpu_lanemap(win):
    idx, x, want = _lanemap_case(win)
    np.testing.assert_array_equal(_plain(kernels.lanemap_plain, idx, x),
                                  want)
    # the script's own exactness check (perf_k1_lanemap.py:101-105)
    st = idx[:8].astype(np.int64)
    lo, a = st & 127, (st >> 8) & 127
    i = np.arange(8)[:, None]
    np.testing.assert_array_equal(want[:8], x[a[i, lo] * 128 + lo])


@pytest.mark.parametrize("mode", k1_rowmatch.MODES)
@pytest.mark.parametrize("win", WINDOWS)
def test_window_gather_plain_equals_tpu_rowmatch_script(win, mode):
    idx, x, want = _window_case("perf_k1_rowmatch", win, mode)
    np.testing.assert_array_equal(
        _plain(kernels.window_gather_plain, idx, x, mode), want)


@pytest.mark.parametrize("mode", k1_sublane.MODES)
@pytest.mark.parametrize("win", WINDOWS)
def test_sublane_plain_equals_tpu_sublane_script(win, mode):
    idx, x, want = _window_case("perf_k1_sublane", win, mode)
    np.testing.assert_array_equal(
        _plain(lambda i, t: k1_sublane.plain(mode, i, t), idx, x), want)


@pytest.mark.parametrize("win", WINDOWS)
def test_rowmatch_is_x_idx_only_on_row_matched_input(win):
    idx, x, want = _window_case("perf_k1_rowmatch", win, "rowmatch")
    assert _x_idx_share(want[:ROWS], idx[:ROWS], x) == 1.0  # the script's
    share = _x_idx_share(want[ROWS:], idx[ROWS:], x)  # arbitrary
    assert 0.08 < share < 0.17, share
    rowscan = _window_case("perf_k1_rowmatch", win, "rowscan")[2]
    np.testing.assert_array_equal(rowscan, x[idx.astype(np.int64)])


@pytest.mark.parametrize("win", WINDOWS)
def test_sublane_is_not_x_idx(win):
    """The script's "exact match vs rowscan" is False on its own input:
    about one slot in eight (1/8 + 7/8 * 1/128) equals x[idx]."""
    idx, x, want = _window_case("perf_k1_sublane", win, "sublane")
    for block in (slice(0, ROWS), slice(ROWS, None)):
        share = _x_idx_share(want[block], idx[block], x)
        assert 0.08 < share < 0.2, share
    rowscan = _window_case("perf_k1_sublane", win, "rowscan")[2]
    assert not np.array_equal(rowscan, want)


def test_wrappers_run_the_plain_version_on_the_cpu():
    idx, x, _ = _window_case("perf_k1_sublane", 1024, "sublane")
    i, xt = torch.from_numpy(idx), torch.from_numpy(x)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(kernels.sublane(i, xt), kernels.sublane_plain(i, xt))
    for mode in kernels.MODES:
        assert torch.equal(kernels.window_gather(i, xt, mode),
                           kernels.window_gather_plain(i, xt, mode))
    assert torch.equal(kernels.lanemap(i, xt), kernels.lanemap_plain(i, xt))
    t = torch.from_numpy(np.random.default_rng(1).random(
        (8, 128)).astype(np.float32))
    assert torch.equal(kernels.row_gather(i, t),
                       kernels.row_gather_plain(i, t))
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="rowscan|rowmatch"):
        kernels.window_gather(i, xt, "sublane")


def test_script_inputs_match_the_scripts_draws():
    """The builders draw what the scripts' main loops draw (seed 0, one
    generator over the windows in order)."""
    rng = np.random.default_rng(0)
    for win, idx, x in k1_sublane.sublane_inputs(WINDOWS, nblk=1):
        np.testing.assert_array_equal(
            idx, rng.integers(0, win, size=(ROWS, 128)).astype(np.uint16))
        np.testing.assert_array_equal(x, rng.random(win).astype(np.float32))
    rng = np.random.default_rng(0)
    r3 = np.broadcast_to((np.arange(ROWS) % 8)[:, None], (ROWS, 128))
    for win, idx, x in k1_rowmatch.rowmatch_inputs(k1_rowmatch.WINDOWS, 1):
        grp = rng.integers(0, win // 1024, size=(ROWS, 128))
        lo = rng.integers(0, 128, size=(ROWS, 128))
        assert idx.dtype == np.uint16
        np.testing.assert_array_equal(
            idx, ((grp * 8 + r3) * 128 + lo).astype(np.uint16))
        np.testing.assert_array_equal(x, rng.random(win).astype(np.float32))
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2048 // 128, (ROWS, 128)).astype(np.uint16)
    lo = rng.integers(0, 128, (ROWS, 128)).astype(np.uint16)
    st, x = k1_lanemap.lanemap_input(2048, nblk=1)
    np.testing.assert_array_equal(st, lo | (a << 8))
    np.testing.assert_array_equal(x, rng.random(2048).astype(np.float32))


@pytest.mark.parametrize("module", [k1_lanemap, k1_rowmatch, k1_sublane],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_entry_point_runs_on_the_cpu(module, capsys):
    assert module.main(["--device", "cpu", "--blocks", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{module.__name__.rsplit('.', 1)[1]} on cpu")
    assert all("exact=True" in line for line in out[1:])
    assert len(out) > 3


def test_entry_point_results_on_the_cpu():
    res = k1_rowmatch.bench((1024,), nblk=1, device="cpu", reps=1)
    assert [r["mode"] for r in res] == ["rowscan", "rowmatch"]
    assert res[1]["x_idx_share"] == 1.0 and "x_idx_share" not in res[0]
    res = k1_sublane.bench((2048,), nblk=1, device="cpu", reps=1)
    assert 0.08 < res[1]["x_idx_share"] < 0.2
    assert res[1]["kernel"] == "probe_sublane"
    assert res[0]["kernel"] == "probe_window_gather"
    seen = []
    res = k1_lanemap.depth_probe(nblk=1, device="cpu", reps=1,
                                 observe=lambda r, t: seen.append(r))
    assert seen == res and [r["rows"] for r in res] == list(k1_lanemap.ROWS)
    assert all(r["exact"] and r["slots"] == BLK
               and r["bytes"] == 6 * BLK + 4 * 128 * r["rows"] for r in res)


def test_entry_points_raise_without_device_or_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: k1_lanemap.depth_probe(nblk=1),
             lambda: k1_lanemap.lanemap_bench(1024, nblk=1),
             lambda: k1_rowmatch.bench((1024,), nblk=1),
             lambda: k1_sublane.bench((1024,), nblk=1),
             lambda: k1_lanemap.main([]), lambda: k1_rowmatch.main([]),
             lambda: k1_sublane.main(["1024"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
