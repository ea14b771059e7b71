"""The K2 stream-floor probes of graph_tpu_torch against the TPU kernels
of ``scripts/perf_k2_{io,io2,io3,io4,io5,streams}.py``, run in interpret
mode.

Each case runs the script's kernel through ``pl.pallas_call(...,
interpret=True)`` with the script's ``PrefetchScalarGridSpec`` at 8-32
sections and 1-3 passes, and holds two things of the port to it bit for
bit: the plain version (``k2_kernels.sec_stream`` on CPU tensors) and a
step-for-step model of the CUDA kernel over the port's schedule (its
pieces, stores, atomic adds and dead reads), since the kernel itself runs
only on the card.  Interpret mode fills a fresh int32 output with
INT32_MIN and an f32 one with NaN, so blocks never zeroed or never touched
are compared with ``init`` set to those.

``perf_k2_io.py`` is loaded by file path and its own ``run_variant`` runs
(its ``pl`` and ``timeit`` swapped for interpret mode and a capture).  The
other scripts cannot be imported (they import ``graph_tpu``, enable a
compile cache, import ``perf_attr``, or run at import), and their kernels
are closures over ``main``'s locals: the kernels below are verbatim copies
of those closures, checked against the scripts' text with ``ast``.
"""

import ast
import functools
import importlib.util
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from graph_tpu_torch.probes import (
    k2_io, k2_io2, k2_io3, k2_io4, k2_io5, k2_kernels as kk, k2_layout,
    k2_streams)
from graph_tpu_torch.probes.k2_layout import SEC_R, Steps

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
INT32_MIN = -(1 << 31)
#: A hand-made layout: five mids, mid 1 a single section (12 sections).
SEC_MID = np.array([0, 0, 0, 1, 2, 2, 2, 2, 2, 3, 3, 4], np.int32)
NMID = 5
SIDE_NAMES = k2_layout.SIDE_NAMES


# ---- verbatim copies of the scripts' kernel closures -----------------------

def io2_kernel(rows):
    """``perf_k2_io2.py``'s ``run_variant`` closures."""
    def sval(ref):
        return ref[0:8, :].astype(jnp.int32)[0, 0]

    def kernel(sm_ref, *refs):
        v_ref = refs[0]
        out_ref = refs[-1]
        k = pl.program_id(0)
        q = jnp.round(v_ref[:] * jnp.float32(1 << 30)).astype(jnp.int32)
        touch = jnp.int32(0)
        for r in refs[1:-1]:
            touch = touch + sval(r)
        first = (k == 0) | (sm_ref[k] != sm_ref[jnp.maximum(k - 1, 0)])

        @pl.when(first)
        def _():
            out_ref[:] = jnp.zeros_like(out_ref)
        out_ref[:rows, :] += q + touch
    return kernel


def io3_kernel(compute, outmode):
    """``perf_k2_io3.py``'s ``mk`` closure."""
    def kernel(sm_ref, *refs):
        v_ref = refs[0]
        out_ref = refs[-1]
        k = pl.program_id(0)
        if compute:
            q = jnp.round(v_ref[:] * jnp.float32(1 << 30)).astype(jnp.int32)
        else:
            q = pltpu.bitcast(v_ref[:], jnp.int32)
        touch = jnp.int32(0)
        for r in refs[1:-1]:
            touch = touch + r[0:8, :].astype(jnp.int32)[0, 0]
        if outmode == "acc":
            first = (k == 0) | (sm_ref[k] != sm_ref[jnp.maximum(k - 1, 0)])

            @pl.when(first)
            def _():
                out_ref[:] = jnp.zeros_like(out_ref)
            out_ref[:] += q[:SEC_R, :] + touch
        else:
            out_ref[:] = q[:SEC_R, :] + touch
    return kernel


def io4_multipass_kernel():
    """``perf_k2_io4.py``'s ``mk_multipass`` closure."""
    def kernel(sm_ref, *refs):
        v_ref, out_ref = refs[0], refs[-1]
        k = pl.program_id(1)
        q = jnp.round(v_ref[:] * jnp.float32(1 << 30)).astype(jnp.int32)
        touch = jnp.int32(0)
        for rf in refs[1:-1]:
            touch = touch + rf[0:8, :].astype(jnp.int32)[0, 0]
        first = (k == 0) | (sm_ref[k] != sm_ref[jnp.maximum(k - 1, 0)])

        @pl.when(first)
        def _():
            out_ref[:] = jnp.zeros_like(out_ref)
        out_ref[:] += q + touch
    return kernel


def io4_onepass_kernel():
    """``perf_k2_io4.py``'s ``mk_onepass`` closure."""
    def kernel(sm_ref, *refs):
        v_ref, out_ref = refs[0], refs[-1]
        k = pl.program_id(0)
        q = jnp.round(v_ref[:] * jnp.float32(1 << 30)).astype(jnp.int32)
        touch = jnp.int32(0)
        for rf in refs[1:-1]:
            touch = touch + rf[0:8, :].astype(jnp.int32)[0, 0]
        first = (k == 0) | (sm_ref[k] != sm_ref[jnp.maximum(k - 1, 0)])

        @pl.when(first)
        def _():
            out_ref[:] = jnp.zeros_like(out_ref)
        out_ref[:] += q + touch
    return kernel


def io5_kernel(outmode):
    """``perf_k2_io5.py``'s ``mk`` closure."""
    def kernel(sm_ref, *refs):
        v_ref, out_ref = refs[0], refs[-1]
        k = pl.program_id(0)
        q = jnp.round(v_ref[:] * jnp.float32(1 << 30)).astype(jnp.int32)
        for rf in refs[1:-1]:
            q = q + rf[:].astype(jnp.int32)  # full-block read
        if outmode == "acc":
            first = (k == 0) | (sm_ref[k] != sm_ref[jnp.maximum(k - 1, 0)])

            @pl.when(first)
            def _():
                out_ref[:] = jnp.zeros_like(out_ref)
            out_ref[:] += q
        else:
            out_ref[:] = q
    return kernel


def streams_kernel():
    """``perf_k2_streams.py``'s ``bench`` closure."""
    def kernel(sm_ref, *refs):
        out_ref = refs[-1]
        k = pl.program_id(0)
        acc = refs[0][:]
        for r in refs[1:-1]:
            acc = acc + r[0:8, :].astype(jnp.int32).astype(jnp.float32)[0, 0]
        first = (k == 0) | (sm_ref[k] != sm_ref[jnp.maximum(k - 1, 0)])

        @pl.when(first)
        def _():
            out_ref[:] = jnp.zeros_like(out_ref)
        out_ref[:] += acc
    return kernel


#: (script, its enclosing function, this file's copy), each copy's inner
#: definitions held to the script's.
COPIES = (("perf_k2_io2", "run_variant", "io2_kernel"),
          ("perf_k2_io3", "mk", "io3_kernel"),
          ("perf_k2_io4", "mk_multipass", "io4_multipass_kernel"),
          ("perf_k2_io4", "mk_onepass", "io4_onepass_kernel"),
          ("perf_k2_io5", "mk", "io5_kernel"),
          ("perf_k2_streams", "bench", "streams_kernel"))


def _inner_defs(path: Path, outer: str) -> dict:
    """{name: source} of the functions defined directly in ``outer``
    (anywhere in the file), each dedented to column 0."""
    text = path.read_text()
    tree = ast.parse(text)
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == outer)
    out = {}
    for node in fn.body:
        if isinstance(node, ast.FunctionDef):
            seg = ast.get_source_segment(text, node, padded=True)
            out[node.name] = textwrap.dedent(seg)
    return out


@pytest.mark.parametrize("script,outer,copy", COPIES,
                         ids=[f"{s}.{o}" for s, o, _ in COPIES])
def test_kernel_copies_are_verbatim(script, outer, copy):
    want = _inner_defs(SCRIPTS / f"{script}.py", outer)
    got = _inner_defs(Path(__file__), copy)
    assert "kernel" in got and got
    for name, src in got.items():
        assert src == want[name], f"{copy}.{name} differs from {script}"


# ---- the port's side: plain version and a model of the kernel -------------

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def kernel_model(v, sides, sched, mode, read, init):
    """What ``csrc/k2_probes.cu`` computes from a schedule: each piece's
    sums over its chain from its start value, then a store, an add into
    the init-filled out, or nothing (a dead piece)."""
    steps = sched.steps
    f32 = mode == "float"
    rows = sched.chain[:, None] + torch.arange(steps.h)
    if f32:
        c = v[rows]
        for s in sides:
            c = c + s[:, 0].to(torch.int32)[sched.chain].to(
                torch.float32)[:, None, None]
    else:
        c = kk._quantize(v[rows], mode).to(torch.int64)
        for s in sides:
            c += (s.to(torch.int32)[rows] if read == "full" else
                  s[:, 0].to(torch.int32)[sched.chain][:, None, None])
    c = c.reshape(len(sched.chain), -1)
    dtype = torch.float32 if f32 else torch.int64
    out = torch.full((steps.nout, steps.h * 128), init, dtype=dtype)
    for block, off, count, word in sched.pieces.tolist():
        kind, zeroed, first = word & 15, word & kk.ZEROED, word & kk.FIRST
        start = 0
        if kind == kk.STORE and not zeroed:
            start = init
        if kind == kk.ADD and first and zeroed:
            start = -init
        acc = torch.full((steps.h * 128,), start, dtype=dtype)
        for i in range(off, off + count):
            acc = acc + c[i]
        if kind == kk.STORE:
            out[block] = acc
        elif kind == kk.ADD:
            out[block] += acc
    if not f32:
        out = torch.remainder(out + (1 << 31), 1 << 32) - (1 << 31)
        out = out.to(torch.int32)
    return out.view(-1, 128)


def port(steps, v, sides, mode, read, init):
    """(plain version, kernel model) as numpy."""
    vt, st = _t(v), [_t(s) for s in sides]
    f32 = mode == "float"
    sched = kk.schedule(steps, "cpu", ordered=f32)
    if f32:
        plain = kk.sec_stream_f32(vt, st, sched, init)
    else:
        plain = kk.sec_stream(vt, st, sched, mode, read, init)
    return plain.numpy(), kernel_model(vt, st, sched, mode, read,
                                       init).numpy()


def assert_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def hold(tpu_out, steps, v, sides, mode, read):
    init = float("nan") if mode == "float" else INT32_MIN
    plain, model = port(steps, v, sides, mode, read, init)
    assert_bits(plain, tpu_out)
    assert_bits(model, tpu_out)


# ---- inputs ----------------------------------------------------------------

def arbitrary_v(rows, seed, scale):
    """f32 rows with halves and negatives: ``scale`` * uniform(-1, 1),
    every eighth value an exact ``(j + 0.5) / 2^30`` (round half to even
    at 2^30) and, where ``scale`` leaves ``round(v * 2^30)`` out of range
    anyway (trunc only), every eighth an exact ``j + 0.5`` (trunc toward
    zero)."""
    g = np.random.default_rng(seed)
    v = (g.uniform(-1, 1, (rows, 128)) * scale).astype(np.float32)
    j = g.integers(-1000, 1000, (rows, 128))
    v[:, ::8] = ((j[:, ::8] + 0.5) / 2.0**30).astype(np.float32)
    if scale > 2:
        v[:, 1::8] = (j[:, 1::8] + 0.5).astype(np.float32)
    return v


def u16_sides(rows, seed, count=5):
    g = np.random.default_rng(seed)
    return [g.integers(0, 1 << 16, (rows, 128)).astype(np.uint16)
            for _ in range(count)]


# ---- perf_k2_io.py: the script's own run_variant ---------------------------

@functools.lru_cache(maxsize=None)
def _io_script():
    """``perf_k2_io.py`` loaded by path, its ``pl`` calling Pallas in
    interpret mode and its ``timeit`` capturing the output."""
    spec = importlib.util.spec_from_file_location(
        "_k2_io_interpret", SCRIPTS / "perf_k2_io.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        BlockSpec=pl.BlockSpec, program_id=pl.program_id, when=pl.when,
        pallas_call=functools.partial(pl.pallas_call, interpret=True))
    mod.captured = []

    def timeit(fn, *args, reps=3):
        mod.captured.append(np.asarray(fn(*args)))
        return 1.0

    mod.timeit = timeit
    return mod


#: The script's layout at 32 sections, and a hand-made one out of order.
IO_LAYOUTS = {"script": np.arange(32, dtype=np.int32) // 16,
              "hand": np.array([1] + [0] * 9 + [1] + [0] * 5 + [1] * 16,
                               np.int32)}
#: (variant, layout, passes): every variant; B over 1 and 3 passes.
IO_CASES = (("A", "script", 2), ("B", "script", 1), ("B", "script", 3),
            ("C", "script", 2), ("D", "script", 2), ("E", "script", 1),
            ("F", "script", 2), ("B", "hand", 2), ("F", "hand", 2))


def _io_tpu(variant, sm, passes, v, sides):
    mod = _io_script()
    nsec = len(sm)
    if variant == "A":  # main's copy (perf_k2_io.py:119-126)
        call = pl.pallas_call(
            mod._copy_kernel, grid=(passes, nsec),
            in_specs=[pl.BlockSpec((SEC_R, 128), lambda rr, k: (k, 0))],
            out_specs=pl.BlockSpec((SEC_R, 128), lambda rr, k: (k, 0)),
            out_shape=jax.ShapeDtypeStruct((nsec * SEC_R, 128), jnp.int32),
            interpret=True)
        return np.asarray(call(jnp.asarray(v)))
    kernel, n_in, kw = {
        "B": (mod._sink4_kernel, 4, dict(out_mode="revisit")),
        "C": (mod._sink4_nout_kernel, 4, dict(out_mode="fresh")),
        "D": (mod._sink1_kernel, 1, dict(out_mode="revisit")),
        "E": (mod._sink4_kernel, 4, dict(out_mode="revisit", vmem_mb=100)),
        "F": (mod._sink4_kernel, 4, dict(out_mode="revisit",
                                         block_secs=2))}[variant]
    streams = tuple(jnp.asarray(a) for a in (v, *sides)) + (
        jnp.asarray(sm),)
    mod.run_variant(variant, kernel, streams, passes, n_in=n_in, nsec=nsec,
                    **kw)
    return mod.captured.pop()


@pytest.mark.parametrize("variant,layout,passes", IO_CASES)
def test_k2_io_variant_equals_tpu(variant, layout, passes):
    sm = IO_LAYOUTS[layout]
    v = arbitrary_v(len(sm) * SEC_R, 1, 3000.0)
    sides = u16_sides(len(sm) * SEC_R, 2, 3)
    want = _io_tpu(variant, sm, passes, v, sides)
    nsides = dict((var, n) for _, var, n in k2_io.VARIANTS)[variant]
    steps = k2_layout.k2_io_steps(sm, variant, passes)
    hold(want, steps, v, sides[:nsides], "trunc", "full")
    if layout == "script" and variant in ("B", "F"):
        # F never touches its blocks from 16 on (here: block 1)
        assert (want == INT32_MIN).all(axis=1).any() == (variant == "F")


def test_k2_io_blocks_accumulate_across_passes():
    """On the script's own layout, block 1 (never
    zeroed) reads INT32_MIN + sum after one pass, + 2 sums after two."""
    sm = IO_LAYOUTS["script"]
    v = np.random.default_rng(0).random((32 * SEC_R, 128), np.float32)
    sides = u16_sides(32 * SEC_R, 3, 3)
    one, two = (_io_tpu("B", sm, p, v, sides) for p in (1, 2))
    blk = sum(s[16 * SEC_R:].astype(np.int64) for s in sides).reshape(
        16, SEC_R, 128).sum(0)
    np.testing.assert_array_equal(one[SEC_R:].astype(np.int64) - INT32_MIN,
                                  blk)
    np.testing.assert_array_equal(two[SEC_R:].astype(np.int64) - INT32_MIN,
                                  2 * blk)


# ---- perf_k2_io2.py .. perf_k2_io5.py on a hand-made layout ----------------

def _prefetch_call(kernel, grid, in_specs, out_spec, out_shape):
    gs = pltpu.PrefetchScalarGridSpec(num_scalar_prefetch=1, grid=grid,
                                      in_specs=in_specs, out_specs=out_spec)
    return pl.pallas_call(kernel, grid_spec=gs, out_shape=out_shape,
                          interpret=True)


def _run(call, sm, v, ins):
    return np.asarray(call(jnp.asarray(sm), jnp.asarray(v),
                           *[jnp.asarray(a) for a in ins]))


@functools.lru_cache(maxsize=None)
def _layout_inputs(sm_key):
    sm = np.array(sm_key, np.int32)
    rows = len(sm) * SEC_R
    return arbitrary_v(rows, 10, 1.9), u16_sides(rows, 11)


def _io2_tpu(mode, sm, nmid, v, sides):
    """``perf_k2_io2.py:35-76``'s grid spec."""
    nstream = {"io1": 6, "io1_fixout": 6, "io1_4s": 4, "io1_2s": 2,
               "io2": 6}[mode]
    rows = SEC_R * (2 if mode == "io2" else 1)
    grid = len(sm) // (2 if mode == "io2" else 1)
    if mode == "io1_fixout":
        out_map = lambda k, sm: (0, 0)  # noqa: E731
    elif mode == "io2":
        out_map = lambda k, sm: (sm[2 * k] // 2, 0)  # noqa: E731
    else:
        out_map = lambda k, sm: (sm[k], 0)  # noqa: E731
    bs = pl.BlockSpec((rows, 128), lambda k, sm: (k, 0))
    call = _prefetch_call(io2_kernel(rows), (grid,), [bs] * nstream,
                          pl.BlockSpec((rows, 128), out_map),
                          jax.ShapeDtypeStruct((max(nmid, 2) * rows, 128),
                                               jnp.int32))
    return _run(call, sm, v, sides[:nstream - 1])


@pytest.mark.parametrize("mode,nsides", k2_io2.MODES)
def test_k2_io2_mode_equals_tpu(mode, nsides):
    v, sides = _layout_inputs(tuple(SEC_MID))
    want = _io2_tpu(mode, SEC_MID, NMID, v, sides)
    steps = k2_layout.k2_io2_steps(SEC_MID, NMID, mode)
    hold(want, steps, v, sides[:nsides], "round", "touch")
    if mode == "io2":  # blocks sm[2k] // 2 only: 3 and 4 are never written
        assert (want.reshape(NMID, -1)[3:] == INT32_MIN).all()


def _io3_tpu(variant, sm, nmid, v, sides):
    """``perf_k2_io3.py:81-141``'s ``mk`` and its calls (143-156)."""
    nstream, rows_per, outmode, compute, merged_meta = {
        "copy1": (1, SEC_R, "step", False, False),
        "copy6": (6, SEC_R, "acc", True, False),
        "copy6w": (6, SEC_R, "acc", True, True),
        "copy6deep": (6, 4 * SEC_R, "acc", True, False),
        "copy6sk": (6, SEC_R, "step", True, False),
        "copy6noq": (6, SEC_R, "acc", False, False)}[variant]
    grid = len(sm) // (rows_per // SEC_R)
    step = rows_per // SEC_R
    bs_in = pl.BlockSpec((rows_per, 128), lambda k, sm: (k, 0))
    if merged_meta:
        in_specs = [bs_in, pl.BlockSpec((rows_per, 640),
                                        lambda k, sm: (k, 0))]
        ins = [np.concatenate(sides, axis=1)]
    else:
        in_specs = [bs_in] * nstream
        ins = sides[:nstream - 1]
    if outmode == "acc":
        out_map = (lambda k, sm: (sm[k * step], 0))
    else:
        out_map = (lambda k, sm: (k % max(nmid, 2), 0))
    call = _prefetch_call(io3_kernel(compute, outmode), (grid,), in_specs,
                          pl.BlockSpec((SEC_R, 128), out_map),
                          jax.ShapeDtypeStruct((max(nmid, 2) * SEC_R, 128),
                                               jnp.int32))
    return _run(call, sm, v, ins), ins


@pytest.mark.parametrize("variant", k2_layout.IO3_VARIANTS)
def test_k2_io3_variant_equals_tpu(variant):
    v, sides = _layout_inputs(tuple(SEC_MID))
    want, ins = _io3_tpu(variant, SEC_MID, NMID, v, sides)
    mode = next(m for name, m, _, _ in k2_io3.VARIANTS if name == variant)
    steps = k2_layout.k2_io3_steps(SEC_MID, NMID, variant)
    hold(want, steps, v, ins, mode, "touch")


def _io4_tpu(variant, sm, nmid, v, sides, r):
    """``perf_k2_io4.py``'s ``mk_multipass`` (85-114) and ``mk_onepass``
    (123-159) grid specs."""
    nstream = 1 if variant == "multipass1" else 6
    out_shape = jax.ShapeDtypeStruct((max(nmid, 2) * SEC_R, 128), jnp.int32)
    if variant == "onepass6":
        call = _prefetch_call(
            io4_onepass_kernel(), (len(sm),),
            [pl.BlockSpec((SEC_R, 128), lambda k, sm: (k, 0))] * nstream,
            pl.BlockSpec((SEC_R, 128), lambda k, sm: (sm[k], 0)), out_shape)
    else:
        call = _prefetch_call(
            io4_multipass_kernel(), (r, len(sm)),
            [pl.BlockSpec((SEC_R, 128), lambda rr, k, sm: (k, 0))] * nstream,
            pl.BlockSpec((SEC_R, 128), lambda rr, k, sm: (sm[k], 0)),
            out_shape)
    return _run(call, sm, v, sides[:nstream - 1])


@pytest.mark.parametrize("variant,passes", (("multipass6", 3),
                                            ("multipass1", 2),
                                            ("onepass6", 1)))
def test_k2_io4_variant_equals_tpu(variant, passes):
    v, sides = _layout_inputs(tuple(SEC_MID))
    want = _io4_tpu(variant, SEC_MID, NMID, v, sides, passes)
    if variant == "onepass6":
        steps = k2_layout.acc_steps(SEC_MID, NMID)
    else:
        steps = k2_layout.k2_io4_multipass_steps(SEC_MID, NMID, passes)
    nsides = 0 if variant == "multipass1" else 5
    hold(want, steps, v, sides[:nsides], "round", "touch")


def _io5_tpu(variant, sm, nmid, v, sides):
    """``perf_k2_io5.py:79-121``'s ``mk``."""
    nstream, outmode = {"read1": (1, "acc"), "read2": (2, "acc"),
                        "read4": (4, "acc"), "read6": (6, "acc"),
                        "read6n": (6, "step")}[variant]
    bs = pl.BlockSpec((SEC_R, 128), lambda k, sm: (k, 0))
    out_map = ((lambda k, sm: (sm[k], 0)) if outmode == "acc"
               else (lambda k, sm: (k % max(nmid, 2), 0)))
    call = _prefetch_call(io5_kernel(outmode), (len(sm),), [bs] * nstream,
                          pl.BlockSpec((SEC_R, 128), out_map),
                          jax.ShapeDtypeStruct((max(nmid, 2) * SEC_R, 128),
                                               jnp.int32))
    return _run(call, sm, v, sides[:nstream - 1])


@pytest.mark.parametrize("variant,nsides", k2_io5.VARIANTS)
def test_k2_io5_variant_equals_tpu(variant, nsides):
    v, sides = _layout_inputs(tuple(SEC_MID))
    want = _io5_tpu(variant, SEC_MID, NMID, v, sides)
    steps = k2_layout.k2_io5_steps(SEC_MID, NMID, variant)
    hold(want, steps, v, sides[:nsides], "round", "full")


# ---- perf_k2_streams.py: the f32 adds --------------------------------------

STREAMS_NSEC = 36  # 18 divides it: the last of nmid = 3 blocks is untouched


def _streams_tpu(sm, nmid, arrs):
    """``perf_k2_streams.py:65-71``'s grid spec."""
    call = _prefetch_call(
        streams_kernel(), (len(sm),),
        [pl.BlockSpec((SEC_R, 128), lambda k, sm: (k, 0))] * len(arrs),
        pl.BlockSpec((SEC_R, 128), lambda k, sm: (sm[k], 0)),
        jax.ShapeDtypeStruct((nmid * SEC_R, 128), jnp.float32))
    return _run(call, sm, arrs[0], arrs[1:])


@pytest.mark.parametrize("nstreams,dtypes", k2_streams.CASES,
                         ids=[f"{n}streams" for n, _ in k2_streams.CASES])
def test_k2_streams_case_equals_tpu(nstreams, dtypes):
    v, ints = k2_streams.streams_inputs(STREAMS_NSEC)
    # values past f32's 24-bit mantissa make each add round
    g = np.random.default_rng(nstreams)
    big = [x + g.integers(0, 1 << 28, x.shape).astype(np.int32)
           for x in ints[:2]]
    for sides_np in (ints, big + ints[2:]):
        sides = [x.astype(torch.empty(0, dtype=dt).numpy().dtype)
                 for x, dt in zip(sides_np, dtypes)]
        sm, nmid = k2_layout.streams_layout(STREAMS_NSEC)
        want = _streams_tpu(sm, nmid, [v, *sides])
        assert np.isnan(want[2 * SEC_R:]).all()
        steps = k2_layout.k2_streams_steps(sm, nmid)
        hold(want, steps, v, sides, "float", "touch")


def test_k2_streams_inputs_are_the_scripts_draws():
    """``perf_k2_streams.py:40-47`` for each case, from a fresh seed."""
    v, ints = k2_streams.streams_inputs(STREAMS_NSEC)
    for nstreams, dtypes in k2_streams.CASES:
        rng = np.random.default_rng(0)
        shape = (STREAMS_NSEC * SEC_R, 128)
        np.testing.assert_array_equal(
            (rng.random(shape) * 1e-5).astype(np.float32), v)
        for x in ints[:len(dtypes)]:
            np.testing.assert_array_equal(rng.integers(0, 100, shape), x)
    sm, nmid = k2_layout.streams_layout(1024)
    assert nmid == 57 and sm[-1] == 56 and len(sm) == 1024


# ---- a real graph_tpu plan's arrays ----------------------------------------

@functools.lru_cache(maxsize=None)
def _real_plan():
    from graph_tpu.engine.plan import build_plan
    from graph_tpu_torch.generate import host_rmat

    src, dst = host_rmat(12)
    return build_plan(src, dst, 1 << 12, relabel="degree")


@pytest.mark.parametrize("script", ("perf_k2_io2", "perf_k2_io5"))
def test_real_plan_arrays_equal_tpu(script):
    plan = _real_plan()
    sm = np.asarray(plan.sec_mid, np.int32)
    sides = [np.asarray(getattr(plan, name)) for name in SIDE_NAMES]
    v = arbitrary_v(plan.nsec * SEC_R, 20, 1.9)
    assert plan.nmid == 1 and len(sm) >= 2
    if script == "perf_k2_io2":
        want = _io2_tpu("io1", sm, plan.nmid, v, sides)
        steps = k2_layout.k2_io2_steps(sm, plan.nmid, "io1")
        hold(want, steps, v, sides, "round", "touch")
    else:
        want = _io5_tpu("read6", sm, plan.nmid, v, sides)
        steps = k2_layout.k2_io5_steps(sm, plan.nmid, "read6")
        hold(want, steps, v, sides, "round", "full")
    assert (want[SEC_R:] == INT32_MIN).all()  # max(nmid, 2): block 1


# ---- the schedule and the kernel model on random step lists ----------------

@pytest.mark.parametrize("seed", range(6))
def test_kernel_model_equals_plain_on_random_steps(seed):
    """Random out blocks, zero flags, rows (overlapping), passes and
    chains longer than a piece; int32 modes with full and touched sides
    (a 640-wide one), and f32."""
    g = np.random.default_rng(seed)
    nsteps, nout, h = int(g.integers(1, 90)), int(g.integers(1, 5)), 8
    ob = g.integers(0, nout, nsteps)
    if seed % 2:
        ob[:] = 0  # one block, chains of up to 3 * 89 steps
    steps = Steps(g.integers(0, 40, nsteps).astype(np.int64),
                  ob.astype(np.int64), g.random(nsteps) < 0.1 * seed, h,
                  nout + 1, int(g.integers(1, 4)))
    v = arbitrary_v(48, seed, 1.9)
    sides = u16_sides(48, seed + 50, 3)
    init = int(g.integers(INT32_MIN, 1 << 31))
    for mode in kk.MODES:
        for read, use in (("full", sides), ("touch", sides[:2] + [
                np.concatenate([sides[2]] * 5, axis=1)])):
            plain, model = port(steps, v, use, mode, read, init)
            assert_bits(model, plain)
    plain, model = port(steps, v, [s.astype(np.int32) for s in sides],
                        "float", "touch", -2.5)
    assert_bits(model, plain)


def test_schedule_pieces():
    steps = k2_layout.k2_io_steps(IO_LAYOUTS["script"], "B", 3)
    sched = kk.schedule(steps, "cpu")
    p = sched.pieces.numpy()
    assert (p[:, 2] >= 1).all() and (p[:, 2] <= kk.PIECE_STEPS).all()
    assert int(p[:, 2].sum()) == len(sched.chain) == 3 * 32
    # pass by pass, then block: block 0 zeroes every step, so all but its
    # last step are dead; block 1 never zeroes: a piece a pass, each added
    dead, add = kk.DEAD, kk.ADD
    assert p[:, [0, 2, 3]].tolist() == [
        [0, 16, dead], [1, 16, add | kk.FIRST],
        [0, 16, dead], [1, 16, add],
        [0, 15, dead], [0, 1, kk.STORE | kk.ZEROED | kk.FIRST], [1, 16, add]]
    # each piece's rows: its block's sections, in grid order
    for block, off, count, _ in p.tolist():
        first = 16 * block + (off - 48 * block) % 16
        assert sched.chain[off:off + count].tolist() == [
            SEC_R * k for k in range(first, first + count)]
    ordered = kk.schedule(steps, "cpu", ordered=True).pieces.numpy()
    assert ordered[ordered[:, 0] == 1, 2].tolist() == [48]
    long = kk.schedule(k2_layout.acc_steps(np.zeros(70, np.int32), 1),
                       "cpu").pieces.numpy()
    assert long[:, 2].tolist() == [32, 32, 6]
    assert long[:, 3].tolist() == [add | kk.ZEROED | kk.FIRST,
                                   add | kk.ZEROED, add | kk.ZEROED]
    assert kk.moved_bytes(steps, [torch.zeros(1, dtype=torch.uint16)] * 3,
                          "full") == 3 * 32 * SEC_R * 128 * 10 + 2 * 4 * (
        SEC_R * 128)


def test_wrappers_run_the_plain_version_on_the_cpu():
    v, sides = _layout_inputs(tuple(SEC_MID))
    steps = k2_layout.acc_steps(SEC_MID, NMID)
    vt, st = _t(v), [_t(s) for s in sides]
    before = dict(kk.LAUNCHES)
    got = kk.sec_stream(vt, st, kk.schedule(steps, "cpu"), "round", "full")
    assert torch.equal(got, kk.sec_stream_plain(vt, st, steps, "round",
                                                "full"))
    ints = [s.to(torch.int32) for s in st]
    got = kk.sec_stream_f32(vt, ints, kk.schedule(steps, "cpu", True))
    assert torch.equal(got, kk.sec_stream_f32_plain(vt, ints, steps))
    assert kk.LAUNCHES == before
    with pytest.raises(ValueError, match="mode"):
        kk.sec_stream(vt, st, kk.schedule(steps, "cpu"), "floor", "full")
    with pytest.raises(ValueError, match="init"):
        kk.sec_stream(vt, st, kk.schedule(steps, "cpu"), "round", "full",
                      init=1 << 31)


# ---- the section layout ----------------------------------------------------

def test_sections_of_a_csr():
    """Every mid's sections, ``max(1, ceil(in-edges / 65,536))``, in
    order; as numpy and as a tensor."""
    sec = k2_layout.SEC
    # 10 destinations in mids of 4: in-edges 0, 2 * SEC + 1, SEC
    counts = np.zeros(10, np.int64)
    counts[5], counts[6], counts[9] = sec, sec + 1, sec
    indptr = np.concatenate([[0], np.cumsum(counts)])
    want = np.array([0, 1, 1, 1, 2], np.int32)
    for ip in (indptr, torch.from_numpy(indptr)):
        sm, nmid = k2_layout.sections(ip, mid=4)
        assert nmid == 3 and sm.dtype == np.int32
        np.testing.assert_array_equal(sm, want)
    sm, nmid = k2_layout.sections(np.array([0, 5]))
    assert nmid == 1 and sm.tolist() == [0]


def test_rmat_sections_are_monotone_and_cover_every_mid():
    sm, nmid = k2_layout.rmat_sections(14, "degree", "cpu")
    assert nmid == 1 and (np.diff(sm) >= 0).all()
    assert set(sm.tolist()) == set(range(nmid))
    assert len(sm) == -(-(16 << 14) // k2_layout.SEC)
    sm17, nmid17 = k2_layout.rmat_sections(17, None, "cpu")
    assert nmid17 == 2 and set(sm17.tolist()) == {0, 1}
    assert (np.diff(sm17) >= 0).all()


def test_rmat_inputs():
    v, sides = k2_layout.rmat_inputs(3, "cpu")
    rng = np.random.default_rng(1)
    np.testing.assert_array_equal(
        v.numpy(), (rng.random((3 * SEC_R, 128)) * 1e-5).astype(np.float32))
    assert len(sides) == 5 and all(s.dtype == torch.uint16
                                   and s.shape == v.shape for s in sides)
    assert k2_layout.script_reps(72 * (1 << 20)) == 15
    assert k2_layout.script_reps(1 << 30) == 8


# ---- the entry points ------------------------------------------------------

ENTRY_ARGS = ((k2_io, ["--nsec", "32", "--passes", "2", "--reps", "1"]),
              (k2_io2, ["12", "--reps", "1"]),
              (k2_io3, ["12", "none", "--reps", "1"]),
              (k2_io4, ["12", "--reps", "1"]),
              (k2_io5, ["12", "--reps", "1"]),
              (k2_streams, ["36", "--reps", "1"]))


@pytest.mark.parametrize("module,argv", ENTRY_ARGS,
                         ids=lambda a: a.__name__.rsplit(".", 1)[1]
                         if isinstance(a, types.ModuleType) else "")
def test_entry_point_runs_on_the_cpu(module, argv, capsys):
    assert module.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    name = module.__name__.rsplit(".", 1)[1]
    assert out[0].startswith(f"{name} on cpu")
    cases = [line for line in out[1:] if "ctrl_carry" not in line]
    assert cases and all("exact=True" in line and "moved" in line
                         for line in cases)
    if module is k2_io5:
        assert all("slope" in line for line in cases)


def test_entry_point_results_on_the_cpu():
    seen = []
    res = k2_io.bench(32, 1, "cpu", 1,
                      observe=lambda r, inputs: seen.append(inputs[0]))
    assert [r["variant"] for r in res] == list(k2_layout.IO_VARIANTS)
    assert res[4]["note"] == "(a second run of B's launch)"
    assert "note" not in res[1]
    assert all(r["exact"] and r["kernel"] == "probe_sec_stream"
               for r in res)
    assert res[1]["script_bytes"] == 10 * 32 * SEC_R * 128
    assert [s.h for s in seen] == [512] * 5 + [1024]
    res = k2_streams.bench(36, "cpu", 1)
    assert [r["streams"] for r in res] == [6, 4, 2]
    assert all(r["kernel"] == "probe_sec_stream_f32" for r in res)
    v, sides = k2_layout.rmat_inputs(len(SEC_MID), "cpu")
    res = k2_io4.bench(SEC_MID, NMID, "cpu", 1, inputs=(v, sides))
    assert [r["label"] for r in res] == ["ctrl_carry", "multipass6",
                                        "multipass1", "onepass6"]
    assert res[1]["passes"] == 4 and res[3]["passes"] == 1


def test_entry_points_raise_without_device_or_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: k2_io.bench(32, 1), lambda: k2_streams.bench(36),
             lambda: k2_io.main([]), lambda: k2_streams.main(["36"])]
    for module in (k2_io2, k2_io3, k2_io4, k2_io5):
        calls += [functools.partial(module.bench, SEC_MID, NMID),
                  functools.partial(module.main, ["12"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
