"""The K2 stage probes of graph_tpu_torch against the TPU kernels of
``scripts/perf_k2_{stages,route_ops,sec128}.py``, ``perf_k2v2_stages.py``
and ``perf_transpose.py``, run in interpret mode, and the port's section
router against ``graph_tpu``'s.

Each case runs the script's own kernel through ``pl.pallas_call(...,
interpret=True)`` on the same numpy inputs as the port and holds two
things of the port to it bit for bit: the plain version
(``k2_stage_kernels.sec_route`` / ``sec128`` on CPU tensors) and a
step-for-step model of the CUDA kernel over the port's schedule, since the
kernel itself runs only on the card.  Interpret mode fills a fresh int32
output with INT32_MIN, so blocks never zeroed or never written are
compared with ``init`` set to it.

``perf_k2_stages.py`` imports only JAX and is loaded by file path, its
grid shrunk and its ``timeit`` swapped for a capture.  The other scripts
cannot be imported (they import ``graph_tpu``, enable a compile cache,
import ``perf_attr``, or run at import); their kernels are the scripts'
own text, each function and constant cut out of the file with ``ast``
and executed here with the names it uses, Pallas calls made in interpret
mode.
"""

import ast
import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from graph_tpu_torch.engine import kernels as engine_kernels
from graph_tpu_torch.native.edge_plan import route_sections
from graph_tpu_torch.probes import (
    k2_layout, k2_route_ops, k2_routes, k2_sec128, k2_stages, k2v2_stages,
    transpose)
from graph_tpu_torch.probes import k2_stage_kernels as ks
from graph_tpu_torch.probes import route as port_route
from graph_tpu_torch.probes.k2_kernels import ADD, FIRST, STORE, ZEROED
from graph_tpu_torch.probes.k2_layout import SEC_R, Steps

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
INT32_MIN = -(1 << 31)
#: ``pl`` as the scripts use it, every ``pallas_call`` in interpret mode.
PL = types.SimpleNamespace(
    BlockSpec=pl.BlockSpec, program_id=pl.program_id, when=pl.when,
    ds=pl.ds, multiple_of=pl.multiple_of,
    pallas_call=functools.partial(pl.pallas_call, interpret=True))


def script_defs(script: str, names, **env) -> types.SimpleNamespace:
    """The top-level functions and assignments ``names`` of
    ``scripts/<script>.py``, cut out of its text and executed with
    ``env`` (and JAX, ``PL`` as ``pl``, ``pltpu``) as their globals."""
    text = (SCRIPTS / f"{script}.py").read_text()
    tree = ast.parse(text)
    g = {"jax": jax, "jnp": jnp, "np": np, "pl": PL, "pltpu": pltpu, **env}
    found = set()
    for node in tree.body:
        name = (node.name if isinstance(node, ast.FunctionDef) else
                node.targets[0].id if isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Name) else None)
        if name in names:
            exec(compile(ast.Module([node], []), str(SCRIPTS / script),
                         "exec"), g)
            found.add(name)
    assert found == set(names), f"{script}: missing {set(names) - found}"
    return types.SimpleNamespace(**{n: g[n] for n in names})


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- the port's side: plain version and a model of the kernel -------------

def kernel_model(v, sides, program, sched, init):
    """What the stage kernels (``csrc/k2_sections.cu``'s two instances)
    compute from a schedule: each
    piece's sums of its sections' program values from its start value,
    then a store, an add into the init-filled output it names, or nothing
    (a dead piece)."""
    steps_list = sched.steps
    rows = steps_list[0].h
    sec = ks._sections(v, sides, sched.meta, program, sched.chain,
                       rows).reshape(len(sched.chain), -1)
    outs = [torch.full((s.nout, rows * 128), init, dtype=torch.int64)
            for s in steps_list]
    for block, off, count, word in sched.pieces.tolist():
        kind, zeroed, first = word & 15, word & ZEROED, word & FIRST
        start = 0
        if kind == STORE and not zeroed:
            start = init
        if kind == ADD and first and zeroed:
            start = -init
        acc = start + sec[off:off + count].sum(0)
        out = outs[(word >> 8) & 3]
        if kind == STORE:
            out[block] = acc
        elif kind == ADD:
            out[block] += acc
    return [ks._wrap(o).view(-1, 128) for o in outs]


def hold(tpu_outs, program, steps_list, v, sides, meta=None):
    """The plain version and the kernel model, with init INT32_MIN,
    against the TPU outputs bit for bit."""
    vt, st = _t(v), [_t(s) for s in sides]
    sched = ks.schedule(steps_list, "cpu", meta)
    if steps_list[0].h == 512:
        plain = [ks.sec_route(vt, st, program, sched, INT32_MIN)]
    else:
        plain = ks.sec128(vt, st, program, sched, INT32_MIN)
    model = kernel_model(vt, st, program, sched, INT32_MIN)
    for got, mod, want in zip(plain, model, tpu_outs):
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(mod.numpy(), want)


def _prefetch_call(kernel, grid, in_specs, out_specs, out_shape):
    gs = pltpu.PrefetchScalarGridSpec(num_scalar_prefetch=1, grid=grid,
                                      in_specs=in_specs, out_specs=out_specs)
    return pl.pallas_call(kernel, grid_spec=gs, out_shape=out_shape,
                          interpret=True)


# ---- perf_k2_stages.py: the script's own bench ------------------------------

STAGES_NSEC = 32


@functools.lru_cache(maxsize=None)
def _stages_script():
    """``perf_k2_stages.py`` by path, at 32 sections and 2 passes, its
    ``timeit`` capturing the output."""
    spec = importlib.util.spec_from_file_location(
        "_k2_stages_interpret", SCRIPTS / "perf_k2_stages.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.NSEC, mod.R = STAGES_NSEC, 2
    mod.captured = []

    def timeit(fn, *args, reps=3):
        mod.captured.append(np.asarray(fn(*args)))
        return 1.0

    mod.timeit = timeit
    return mod


def _stages_tpu(variant, seed):
    """The script's ``bench`` for one kernel, and the inputs it drew from
    the global ``np.random`` seeded with ``seed``."""
    mod = _stages_script()
    kernel = {"io": mod.k_io, "route": mod.k_route,
              "mxucsum": mod.k_mxucsum, "segscan": mod.k_segscan,
              "compact": mod.k_compact}[variant]
    np.random.seed(seed)
    mod.bench(variant, kernel, 4, with_meta=variant == "compact",
              interpret=True)
    np.random.seed(seed)
    shape = (STAGES_NSEC * SEC_R, 128)
    v = np.random.rand(*shape).astype(np.float32)
    sides = [np.random.randint(0, 1 << 14, shape).astype(np.uint16)
             for _ in range(3)]
    return mod.captured.pop(), v, sides


@pytest.mark.parametrize("variant", k2_stages.VARIANTS)
def test_k2_stages_variant_equals_tpu(variant):
    want, v, sides = _stages_tpu(variant, 5)
    sm = np.arange(STAGES_NSEC, dtype=np.int32) // 16
    steps = k2_layout.k2_io_steps(sm, "B", 2)
    meta = k2_routes.stages_meta(STAGES_NSEC) if variant == "compact" else None
    hold([want], ks.STAGES[variant], [steps], v, sides, meta)
    # block 1 is never zeroed: it adds both passes onto INT32_MIN
    assert steps.zero[16:].sum() == 0 and steps.nout == 2


def test_k2_stages_inputs():
    v, wa, wb, ci, sm, meta = k2_routes.stages_inputs(32)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(v, rng.random(v.shape, dtype=np.float32))
    for x in (wa, wb, ci):
        assert x.dtype == np.uint16 and x.max() < 1 << 14
    assert sm.tolist() == [0] * 16 + [1] * 16
    m = meta.reshape(32, 129)
    assert m[:, 0].tolist() == [1] + [0] * 15 + [1] + [0] * 15
    assert m[0, 1:65].tolist() == [min(1024 * t, 57344) for t in range(64)]
    assert (m[:, 65:] == 2).all()
    ks.check_meta(meta, 32)
    bad = meta.copy()
    bad[128] = 9  # tile 63: rows 448 + 72 > 512
    with pytest.raises(ValueError, match="windows"):
        ks.check_meta(bad, 32)


# ---- perf_k2v2_stages.py and perf_k2_route_ops.py on a graph_tpu plan ------

@functools.lru_cache(maxsize=None)
def _tpu_plan():
    from graph_tpu.engine.plan import build_plan
    from graph_tpu_torch.generate import host_rmat

    src, dst = host_rmat(12)
    return build_plan(src, dst, 1 << 12, relabel="degree")


def _plan_streams():
    plan = _tpu_plan()
    sides = [np.asarray(getattr(plan, n)) for n in k2_layout.SIDE_NAMES]
    v = (np.random.default_rng(1).random((plan.nsec * SEC_R, 128))
         * 1e-5).astype(np.float32)
    return v, sides


#: The plan's two sections as two mids, and both in one.
PLAN_LAYOUTS = {"one_mid": (np.array([0, 0], np.int32), 1),
                "two_mids": (np.array([0, 1], np.int32), 2)}


def _variant_tpu(kernel, sm, nmid, v, sides):
    """``run_variant``'s grid spec (``perf_k2v2_stages.py:79-88``)."""
    call = _prefetch_call(
        kernel, (len(sm),),
        [pl.BlockSpec((SEC_R, 128), lambda k, sm: (k, 0))] * 6,
        pl.BlockSpec((SEC_R, 128), lambda k, sm: (sm[k], 0)),
        jax.ShapeDtypeStruct((nmid * SEC_R, 128), jnp.int32))
    return np.asarray(call(jnp.asarray(sm), jnp.asarray(v),
                           *[jnp.asarray(s) for s in sides]))


@functools.lru_cache(maxsize=None)
def _k2v2_defs():
    from graph_tpu.engine.kernels import FIXED_BITS, _benes, _segmented_scan
    return script_defs("perf_k2v2_stages", ["variant_kernel"],
                       FIXED_BITS=FIXED_BITS, _benes=_benes,
                       _segmented_scan=_segmented_scan)


@pytest.mark.parametrize("layout", PLAN_LAYOUTS)
@pytest.mark.parametrize("mode", k2v2_stages.MODES)
def test_k2v2_mode_equals_tpu(mode, layout):
    v, sides = _plan_streams()
    sm, nmid = PLAN_LAYOUTS[layout]
    want = _variant_tpu(_k2v2_defs().variant_kernel(mode), sm, nmid, v,
                        sides)
    hold([want], ks.K2V2[mode], [k2_routes.route_steps(sm, nmid)], v, sides)


@functools.lru_cache(maxsize=None)
def _route_ops_defs():
    from graph_tpu.engine.kernels import SEC_R as TPU_SEC_R, _benes
    return script_defs("perf_k2_route_ops",
                       ["c_stage_roll", "c_stage_taa", "variant_kernel"],
                       SEC_R=TPU_SEC_R, _benes=_benes)


@pytest.mark.parametrize("mode", k2_route_ops.MODES)
def test_k2_route_ops_mode_equals_tpu(mode):
    v, sides = _plan_streams()
    sm, nmid = PLAN_LAYOUTS["two_mids"]
    want = _variant_tpu(_route_ops_defs().variant_kernel(mode), sm, nmid, v,
                        sides)
    hold([want], ks.ROUTE_OPS[mode], [k2_routes.route_steps(sm, nmid)], v,
         sides)


def test_k2_route_ops_c_stage_alone_equals_tpu():
    """``perf_k2_route_ops.py:160-171``: ``c_stage_taa`` of ``arange`` by
    the plan's first ``wb`` block, and numpy's expectation."""
    d = _route_ops_defs()
    wb0 = np.asarray(_tpu_plan().wb[:SEC_R]).astype(np.int32)
    y0 = np.arange(SEC_R * 128, dtype=np.int32).reshape(SEC_R, 128)
    got = pl.pallas_call(
        lambda y_ref, wb_ref, o_ref: o_ref.__setitem__(
            slice(None), d.c_stage_taa(y_ref[:], wb_ref[:])),
        out_shape=jax.ShapeDtypeStruct((SEC_R, 128), jnp.int32),
        interpret=True)(jnp.asarray(y0), jnp.asarray(wb0))
    exp = np.take_along_axis(
        y0, (np.arange(SEC_R)[:, None] & ~3) | ((wb0 >> 7) & 3), axis=0)
    np.testing.assert_array_equal(np.asarray(got), exp)
    hold([exp], ks.C_ONLY, [k2_routes.section_steps(1, SEC_R)], y0,
         [wb0.astype(np.uint16)])


# ---- perf_k2_sec128.py -----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sec128_defs():
    from graph_tpu.engine.kernels import LANE_SHIFTS
    return script_defs(
        "perf_k2_sec128",
        ["SEC_R2", "_benes128", "ROW_SHIFTS2", "_segscan128", "k2_128",
         "k2_quad"], LANE_SHIFTS=LANE_SHIFTS)


@functools.lru_cache(maxsize=None)
def _sec128_inputs():
    return k2_routes.sec128_inputs(1)


def _sec128_args(sm):
    z = _sec128_inputs()
    return [jnp.asarray(z[k]) for k in ("contrib", "wa_2", "m1_2", "ss_2",
                                        "wa2_2", "m2_2")] + [jnp.asarray(sm)]


#: (stages, lane_steps, row_steps): ``main``'s cases, then the ends of both
#: scan depths, which ``probe_sec128`` unrolls.
SEC128_CASES = ((4, 7, 7), (1, 7, 7), (2, 7, 7), (3, 7, 7), (4, 5, 1),
                (4, 7, 3), (3, 7, 0), (4, 0, 0), (4, 7, 0), (4, 0, 7),
                (4, 1, 7), (2, 3, 5))
#: The script's one section a block, and blocks of two sections.
SEC128_LAYOUTS = {"script": (np.arange(4, dtype=np.int32), 4),
                  "pairs": (np.array([0, 0, 1, 1], np.int32), 2)}


@pytest.mark.parametrize("layout", SEC128_LAYOUTS)
@pytest.mark.parametrize("stages,ls,rs", SEC128_CASES)
def test_k2_128_equals_tpu(stages, ls, rs, layout):
    z = _sec128_inputs()
    sm, nmid = SEC128_LAYOUTS[layout]
    want = np.asarray(_sec128_defs().k2_128(
        *_sec128_args(sm)[:6], jnp.asarray(sm), nmid, row_steps=rs,
        stages=stages, lane_steps=ls))
    steps = k2_routes.route_steps(sm, nmid)
    steps = Steps(steps.row0 // 4, steps.ob, steps.zero, 128, nmid)
    hold([want], ks.sec128_program(stages, ls, rs), [steps], z["contrib"],
         [z[k] for k in ("wa_2", "m1_2", "ss_2", "wa2_2", "m2_2")])


@pytest.mark.parametrize("ls,rs", k2_sec128.QUAD)
def test_k2_quad_equals_tpu(ls, rs):
    """The four outputs' sum (the script's return): every block is written
    by one output; the other three add INT32_MIN each."""
    z = _sec128_inputs()
    sm = np.arange(4, dtype=np.int32)
    want = np.asarray(_sec128_defs().k2_quad(
        *_sec128_args(sm)[:6], jnp.asarray(sm), 4, row_steps=rs,
        lane_steps=ls))
    sides = [_t(z[k]) for k in ("wa_2", "m1_2", "ss_2", "wa2_2", "m2_2")]
    steps_list = k2_sec128.quad_steps(sm, 4)
    program = ks.sec128_program(4, ls, rs)
    sched = ks.schedule(steps_list, "cpu")
    outs = ks.sec128(_t(z["contrib"]), sides, program, sched, INT32_MIN)
    model = kernel_model(_t(z["contrib"]), sides, program, sched, INT32_MIN)
    for got in (outs, model):
        total = sum(o.to(torch.int64) for o in got)
        np.testing.assert_array_equal(ks._wrap(total).numpy(), want)
    assert [s.ob.tolist() for s in steps_list] == [[0], [1], [2], [3]]


def test_sec128_inputs_are_the_scripts_draws():
    """``perf_k2_sec128.py:259-302`` at one 512-row section: the keys, the
    routes (the port's Python ``section128_python`` on the first 128-row
    section) and the contributions."""
    z = _sec128_inputs()
    rng = np.random.default_rng(7)
    k512 = port_route.gen_keys(rng, 65536, 65536)
    k128 = [port_route.gen_keys(rng, 16384, 16384) for _ in range(4)]
    contrib = rng.integers(-1000, 1000, size=(512, 128),
                           dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(z["keys512"][0], k512)
    np.testing.assert_array_equal(z["keys128"], np.stack(k128))
    np.testing.assert_array_equal(z["contrib"], contrib)
    py = port_route.section128_python(k128[0])
    for name, want in zip(("wa_2", "m1_2", "ss_2", "wa2_2", "m2_2"), py):
        np.testing.assert_array_equal(z[name][:128], want)


# ---- perf_transpose.py -----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _transpose_defs():
    return script_defs("perf_transpose",
                       ["body_copy", "body_t512", "body_t128x4",
                        "body_taa512", "body_taa128x4"])


@pytest.mark.parametrize("body", transpose.BODIES)
def test_transpose_body_equals_tpu(body):
    """``mk``'s call (``perf_transpose.py:30-39``) at 4 blocks."""
    d = _transpose_defs()
    fn = {"copy": d.body_copy, "t512x2": d.body_t512,
          "t128x8": d.body_t128x4, "taa512": d.body_taa512,
          "taa128x4": d.body_taa128x4}[body]
    c = transpose.transpose_input(4)

    def kernel(v_ref, out_ref):
        out_ref[:] = fn(v_ref[:])

    want = np.asarray(pl.pallas_call(
        kernel, grid=(4,),
        in_specs=[pl.BlockSpec((512, 128), lambda k: (k, 0))],
        out_specs=pl.BlockSpec((512, 128), lambda k: (k, 0)),
        out_shape=jax.ShapeDtypeStruct((4 * 512, 128), jnp.int32),
        interpret=True)(jnp.asarray(c)))
    rows, program = ks.TRANSPOSE[body]
    hold([want], program, [k2_routes.section_steps(4 * 512 // rows, rows)],
         c, [])


# ---- the scans on a real plan's segment starts -----------------------------

def _real_section():
    """The TPU plan's first section: its sorted segment starts, and
    random int32 values in sorted order."""
    ss = np.asarray(_tpu_plan().sstart[:SEC_R]).astype(np.int32)
    q = np.random.default_rng(3).integers(-2**31, 2**31, (SEC_R, 128),
                                          dtype=np.int64).astype(np.int32)
    return q, ss


def _true_segsum(q, ss):
    """The inclusive sum of each position's segment, [ss[i], i], wrapped."""
    flat = q.reshape(-1).astype(np.int64)
    csum = np.concatenate([[0], np.cumsum(flat)])
    i = np.arange(flat.size)
    got = csum[i + 1] - csum[ss.reshape(-1).astype(np.int64)]
    return got.astype(np.int32).reshape(q.shape)


def _in_kernel(fn, *arrays):
    def kernel(*refs):
        refs[-1][:] = fn(*[r[:] for r in refs[:-1]])
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(arrays[0].shape, jnp.int32),
        interpret=True)(*[jnp.asarray(a) for a in arrays]))


def test_three_scan_forms_are_true_segmented_sums():
    """``_segmented_scan`` and ``_segscan128`` (each at full depth) and the
    port's scan equal the true segmented sum on a real plan's ``sstart``
    (512 rows; the 128-row form on a section of keys routed at 128 rows).
    ``stage_segscan_sum`` quantizes f32 itself: the next test."""
    from graph_tpu.engine.kernels import _segmented_scan

    q, ss = _real_section()
    want = _true_segsum(q, ss)
    assert (np.diff(ss.reshape(-1)) >= 0).all() and len(np.unique(ss)) > 100
    got2 = _in_kernel(lambda q, s: _segmented_scan(q, s, "sum"), q, ss)
    np.testing.assert_array_equal(got2, want)
    port = ks._scan_plain(_t(q).to(torch.int64)[None],
                          _t(ss).to(torch.int64)[None], 7, 9)
    np.testing.assert_array_equal(ks._wrap(port[0]).numpy(), want)
    z = _sec128_inputs()
    q128 = z["contrib"][:128]
    ss128 = z["ss_2"][:128].astype(np.int32)
    got3 = _in_kernel(lambda q, s: _sec128_defs()._segscan128(q, s, 7, 7),
                      q128, ss128)
    np.testing.assert_array_equal(got3, _true_segsum(q128, ss128))


def test_stage_segscan_sum_is_the_true_segmented_sum_of_quanta():
    """``stage_segscan_sum`` quantizes f32 itself: on v = q / 2^30 (exact)
    it is the true segmented sum of q."""
    q, ss = _real_section()
    q = (q >> 8)  # |v| < 2^-7: round(v * 2^30) is q exactly
    v = (q.astype(np.float64) / 2**30).astype(np.float32)
    stages_mod = _stages_script()
    got = _in_kernel(lambda v, s: stages_mod.stage_segscan_sum(v, s), v, ss)
    np.testing.assert_array_equal(got, _true_segsum(q, ss))


# ---- full K2 on the port's routed stand-in ---------------------------------

@functools.lru_cache(maxsize=None)
def _stand_in():
    return k2_routes.rmat_layout(12, "degree", "cpu", nthreads=2)


def test_full_equals_k2_reduce_on_the_stand_in():
    """``full`` (route 1, scan, route 2, present mask) on the routed
    stand-in equals the port's K2 on the same quanta, every destination."""
    from graph_tpu_torch.engine.plan import build_plan
    from graph_tpu_torch.generate import host_rmat

    lay = _stand_in()
    src, dst = host_rmat(12)
    plan = build_plan(src, dst, 1 << 12, relabel="degree", device="cpu")
    steps = k2_routes.route_steps(lay.sec_mid, lay.nmid)
    out = ks.sec_route(lay.v, lay.sides, ks.K2V2["full"],
                       ks.schedule([steps], "cpu"))
    want = engine_kernels.k2_reduce_plain(
        k2_routes.quanta_in_csr_order(lay), plan.indptr)
    assert torch.equal(out.view(-1)[:plan.n], want)
    assert lay.nsec == 2 and lay.nmid == 1


def test_stand_in_keys():
    """Mids of 65,536 destinations, in-edges in source order, a lead pad,
    65,535 edges a section, tail pads; ``pos`` finds every slot's key."""
    g = np.random.default_rng(0)
    n = 70000
    counts = g.integers(0, 3, n)
    counts[5] = 70000  # a hub of the first mid: it takes two sections
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]))
    m = int(indptr[-1])
    slot_src = torch.from_numpy(g.integers(0, n, m).astype(np.int32))
    st = k2_routes.stand_in_keys(indptr, slot_src)
    assert st.nmid == 2 and st.sec_mid.tolist() == [0, 0, 0, 1]
    keys = st.keys.reshape(-1, 65536)
    assert (keys[:, 0] == -1).all()
    dst = np.repeat(np.arange(n), counts)
    np.testing.assert_array_equal(st.keys[st.pos.numpy()], dst % 65536)
    mid0 = np.nonzero(dst < 65536)[0]
    order = mid0[np.argsort(slot_src.numpy()[mid0], kind="stable")]
    np.testing.assert_array_equal(
        np.sort(st.pos.numpy()[order]), st.pos.numpy()[order])
    filled = (keys[:, 1:] != 65536).sum(1)
    assert filled[:2].tolist() == [65535, 65535]
    assert filled.sum() == m


# ---- the routers -----------------------------------------------------------

def test_clos_route_equals_graph_tpu():
    from graph_tpu.engine import route as tpu_route

    perm = np.random.default_rng(4).permutation(128 * 128)
    got, want = port_route.clos_route(perm, 128), tpu_route.clos_route(
        perm, 128)
    for k in "ABCDE":
        np.testing.assert_array_equal(got[k], want[k])
    x = np.arange(128 * 128).reshape(128, 128)
    out = port_route.clos_apply_reference(x, got)
    np.testing.assert_array_equal(out.reshape(-1)[perm], x.reshape(-1))


def _keys512(seed, nsec):
    g = np.random.default_rng(seed)
    out = []
    for s in range(nsec):
        k = np.concatenate([[-1], np.sort(g.integers(0, 65536, 60000 + s)),
                            np.full(65536 - 60001 - s, 65536)])
        out.append(k[g.permutation(65536)])
    return np.concatenate(out).astype(np.int32)


def test_native_router_equals_graph_tpu_at_512_rows():
    """The port's native copy and ``graph_tpu``'s native router on the
    same keys, three sections; and the port's Python router on the
    first."""
    from graph_tpu.engine.native_route import build_sections_native

    keys = _keys512(6, 3)
    got = route_sections(keys, 512, 2)
    want = build_sections_native(keys, 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.reshape(-1), b.reshape(-1))
    py = port_route.section_python(keys[:65536].astype(np.int64))
    for a, b in zip(py, got):
        np.testing.assert_array_equal(a.reshape(-1), b[:512].reshape(-1))


def _unpack(wa, wb, r):
    """The index stages of packed streams (``pack_routing``'s inverse)."""
    wa, wb = wa.astype(np.int64), wb.astype(np.int64).reshape(128, r // 128,
                                                              128)
    return {"A": wa & 127, "E": (wa >> 7) & 127, "B": wb & 127,
            "C": (wb >> 7) & 3, "D": (wb >> 9) & 127}


def test_native_routes_at_128_rows_are_valid():
    """Route 1 of every 128-row section sorts its keys stably (checked by
    ``clos_apply_reference``), its pad bits mark the pads, and route 2
    takes each present destination's segment end to its output."""
    z = _sec128_inputs()
    wa, wb, ss, wa2, wb2 = route_sections(z["keys128"].reshape(-1), 128, 2)
    for s, keys in enumerate(z["keys128"]):
        rows = slice(128 * s, 128 * (s + 1))
        idx = _unpack(wa[rows], wb[rows], 128)
        x = keys.reshape(128, 128)
        routed = port_route.clos_apply_reference(x, idx).reshape(-1)
        np.testing.assert_array_equal(routed, np.sort(keys, kind="stable"))
        pad = (keys == -1) | (keys == 16384)
        np.testing.assert_array_equal((wa[rows] >> 15).reshape(-1), pad)
        starts = np.searchsorted(routed, routed, side="left")
        np.testing.assert_array_equal(ss[rows].reshape(-1), starts)
        ends = port_route.clos_apply_reference(
            np.arange(16384).reshape(128, 128),
            _unpack(wa2[rows], wb2[rows], 128)).reshape(-1)
        present = (wa2[rows] >> 15).reshape(-1).astype(bool)
        d = np.nonzero(present)[0]
        np.testing.assert_array_equal(
            ends[d], np.searchsorted(routed, d, side="right") - 1)
        np.testing.assert_array_equal(
            present, np.isin(np.arange(16384), keys))


# ---- the schedule, the model and the wrappers ------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_kernel_model_equals_plain_on_random_steps(seed):
    """Random out blocks, zero flags, sections, passes and chains longer
    than a piece, into one to four outputs, on random routes."""
    g = np.random.default_rng(seed)
    nsec = 5
    v = (g.random((nsec * 128, 128)) * 3.8 - 1.9).astype(np.float32)
    vi = g.integers(-2**31, 2**31, (nsec * 128, 128)).astype(np.int32)
    sides = [g.integers(0, 1 << 16, (nsec * 128, 128)).astype(np.uint16)
             for _ in range(5)]
    nout = 1 + seed % 4
    steps_list = []
    for _ in range(nout):
        n = int(g.integers(1, 45))
        ob = g.integers(0, 3, n) if seed % 2 else np.zeros(n, np.int64)
        steps_list.append(Steps(g.integers(0, nsec, n) * 128,
                                ob.astype(np.int64), g.random(n) < 0.2, 128,
                                4, int(g.integers(1, 3))))
    init = int(g.integers(INT32_MIN, 1 << 31))
    programs = [(vi, ks.sec128_program(4, 7, 7)),
                (vi, ks.sec128_program(3, 5, 2)),
                (v, (("load", "round", 1), ("gather", 1, 0), ("t",),
                     ("gather", 2, 0), ("ti",), ("mask", 4),
                     ("add_touch", 3), ("add_const", -7)))]
    for vals, program in programs:
        vt, st = _t(vals), [_t(s) for s in sides]
        sched = ks.schedule(steps_list, "cpu")
        plain = ks.sec128(vt, st, program, sched, init)
        model = kernel_model(vt, st, program, sched, init)
        for a, b in zip(plain, model):
            assert torch.equal(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_kernel_model_equals_plain_at_512_rows(seed):
    """``sec_route_outs``: random out blocks, zero flags, sections,
    passes and chains longer than a piece, into one to four outputs, on
    random routes with the C stage, the scan and the compaction;
    ``sec_route`` writes one output and refuses more."""
    g = np.random.default_rng(100 + seed)
    nsec = 3
    vi = g.integers(-2**31, 2**31, (nsec * 512, 128)).astype(np.int32)
    sides = [g.integers(0, 1 << 16, (nsec * 512, 128)).astype(np.uint16)
             for _ in range(5)]
    meta = k2_routes.stages_meta(nsec).reshape(nsec, 129)
    meta[:, 1:65] = g.integers(0, 48, (nsec, 64)) * 1024
    meta[:, 65:] = g.integers(0, 3, (nsec, 64))
    steps_list = []
    for _ in range(1 + seed % 4 + seed // 2):
        n = int(g.integers(1, 20))
        steps_list.append(Steps(g.integers(0, nsec, n) * 512,
                                g.integers(0, 2, n).astype(np.int64),
                                g.random(n) < 0.2, 512, 2,
                                int(g.integers(1, 3))))
    init = int(g.integers(INT32_MIN, 1 << 31))
    vt, st = _t(vi), [_t(s) for s in sides]
    for program in (ks.FULL_INT, (("load", "int"), *ks.route(1, 2),
                                  ("psum",), ("compact", 3))):
        m = meta.reshape(-1) if program[-1][0] == "compact" else None
        sched = ks.schedule(steps_list, "cpu", m)
        plain = ks.sec_route_outs(vt, st, program, sched, init)
        model = kernel_model(vt, st, program, sched, init)
        assert len(plain) == len(steps_list)
        for a, b in zip(plain, model):
            assert torch.equal(a, b)
        if len(steps_list) > 1:
            with pytest.raises(ValueError, match="one output"):
                ks.sec_route(vt, st, program, sched, init)


def test_schedule_merges_outputs():
    sm = np.arange(8, dtype=np.int32)
    sched = ks.schedule(k2_sec128.quad_steps(sm, 8), "cpu")
    p = sched.pieces.numpy()
    assert ((p[:, 3] >> 8) & 3).tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    assert sched.chain.tolist() == [128 * k for k in range(8)]
    assert sorted(p[:, 1].tolist()) == list(range(8))


def test_wrappers_run_the_plain_version_on_the_cpu():
    z = _sec128_inputs()
    sides = [_t(z[k]) for k in ("wa_2", "m1_2", "ss_2", "wa2_2", "m2_2")]
    c = _t(z["contrib"])
    steps = k2_routes.section_steps(4, 128)
    before = dict(ks.LAUNCHES)
    got = ks.sec128(c, sides, ks.sec128_program(), ks.schedule([steps], "cpu"))
    assert torch.equal(got[0], ks.stage_plain(c, sides, ks.sec128_program(),
                                              [steps])[0])
    assert ks.LAUNCHES == before
    bad = [
        (ks.sec128, (c, sides, (("gather", 1, 0),))),           # no load
        (ks.sec128, (c, sides, (("load", "round"),))),          # int32 v
        (ks.sec128, (c, sides[:2], ks.sec128_program())),       # side 3
        (ks.sec128, (c, sides, (("load", "int"), ("ti",)))),    # layout
        (ks.sec128, (c, sides, (("load", "int"), ("c", 2)))),   # 128 rows
        (ks.sec128, (c, sides, (("load", "int"), ("scan", 3, 7, 8)))),
    ]
    for fn, args in bad:
        with pytest.raises(ValueError):
            fn(*args, ks.schedule([steps], "cpu"))
    with pytest.raises(ValueError, match="rows"):
        ks.sec_route(c, sides, ks.FULL_INT, ks.schedule([steps], "cpu"))
    with pytest.raises(ValueError, match="init"):
        ks.sec128(c, sides, ks.sec128_program(), ks.schedule([steps], "cpu"),
                  init=1 << 31)


def test_program_cache_gives_the_encoded_words_and_refuses_again():
    """A checked program's words are ``encode``'s, kept for the next call
    (the same array); a bad program is refused at every call, never
    cached."""
    args = (128, 5, False, torch.int32)
    program = ks.sec128_program(4, 5, 1)
    words = ks.checked_words(program, *args)
    np.testing.assert_array_equal(words, ks.encode(program))
    assert words.dtype == np.int32 and words.flags.c_contiguous
    assert ks.checked_words([list(op) for op in program], *args) is words
    bad = (("load", "int"), ("scan", 3, 7, 8))
    for _ in range(2):
        with pytest.raises(ValueError, match="scan depth"):
            ks.checked_words(bad, *args)
    assert all(key[0] != bad for key in ks._WORDS)
    # the same program refused where its check differs: f32 values
    with pytest.raises(ValueError, match="load"):
        ks.checked_words(program, 128, 5, False, torch.float32)
    z = _sec128_inputs()
    sides = [_t(z[k]) for k in ("wa_2", "m1_2", "ss_2", "wa2_2", "m2_2")]
    sched = ks.schedule([k2_routes.section_steps(4, 128)], "cpu")
    for _ in range(2):
        with pytest.raises(ValueError, match="scan depth"):
            ks.sec128(_t(z["contrib"]), sides, bad, sched)


def test_bytes_and_operations():
    steps = k2_layout.k2_io_steps(np.arange(32) // 16, "B", 3)
    v = torch.zeros(1)
    sides = [torch.zeros(1, dtype=torch.uint16)] * 3
    slots = 3 * 32 * SEC_R * 128
    assert ks.moved_bytes(ks.STAGES["io"], [steps], v, sides) == (
        10 * slots + 4 * 2 * SEC_R * 128)
    assert ks.moved_bytes(ks.STAGES["compact"], [steps], v, sides) == (
        10 * slots + 4 * 129 * 3 * 32 + 4 * 2 * SEC_R * 128)
    assert ks.operations(ks.STAGES["segscan"], [steps]) == 9 * slots
    assert ks.operations(ks.STAGES["route"], [steps]) == 2 * slots


# ---- the entry points ------------------------------------------------------

ENTRY_ARGS = ((k2_stages, ["--nsec", "32", "--passes", "2", "--reps", "1"]),
              (k2v2_stages, ["12", "--reps", "1"]),
              (k2_route_ops, ["12", "none", "--reps", "1"]),
              (k2_sec128, ["1", "--reps", "1"]),
              (transpose, ["--nsec", "2", "--reps", "1"]))


@pytest.mark.parametrize("module,argv", ENTRY_ARGS,
                         ids=lambda a: a.__name__.rsplit(".", 1)[1]
                         if isinstance(a, types.ModuleType) else "")
def test_entry_point_runs_on_the_cpu(module, argv, capsys):
    assert module.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    name = module.__name__.rsplit(".", 1)[1]
    assert out[0].startswith(f"{name} on cpu")
    cases = [line for line in out if "exact=" in line]
    assert cases and all("exact=True" in line for line in cases)
    if module is k2_route_ops:
        assert "c_taa exactness: OK" in out
    if module is k2_sec128:
        assert any(line.startswith("correctness ok") for line in out)


def test_entry_points_raise_without_device_or_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lay = _stand_in()
    calls = [lambda: k2_stages.bench(32, 1), lambda: k2_stages.main([]),
             lambda: k2v2_stages.bench(lay), lambda: k2_route_ops.bench(lay),
             lambda: k2v2_stages.main(["12"]), lambda: k2_sec128.main(["1"]),
             lambda: transpose.bench(2), lambda: transpose.main([])]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
