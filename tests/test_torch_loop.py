"""The port's device-resident loops (``graph_tpu_torch.engine.loop``)
against ``jax.lax.while_loop`` and the algorithms built on them against
``graph_tpu``'s, on the CPU.

On the CPU :func:`device_while` runs its plain version, :func:`host_while`;
the card's conditional CUDA graph is held to it in
``tests/test_torch_kernels.py`` (``-k loop``).  Expected agreement:
integer loops and max-residual loops give the same bits and the same
iteration counts as ``lax.while_loop``; the algorithms give ``graph_tpu``'s
scores (``"cumsum"``'s int32 quanta, bit for bit), labels, distances and
iteration counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graph_tpu_torch as gtt
from graph_tpu import PageRankConfig as JaxPrConfig
from graph_tpu import page_rank as jax_page_rank
from graph_tpu.algos.sssp import DeltaSteppingConfig as JaxSsspConfig
from graph_tpu.algos.sssp import delta_stepping as jax_delta_stepping
from graph_tpu.algos.wcc import WccConfig as JaxWccConfig
from graph_tpu.algos.wcc import wcc as jax_wcc
from graph_tpu.graph.build import build_directed as jax_build_directed
from graph_tpu_torch.algos import sssp
from graph_tpu_torch.engine import loop
from graph_tpu_torch.engine.loop import (
    DeviceLoop, Flag, Residual, While, device_while, host_while)
from graph_tpu_torch.generate import host_rmat


# ------------------------------------------------- host_while vs lax


def _collatz_inputs(seed=7, size=64):
    return np.random.default_rng(seed).integers(1, 10_000, size).astype(
        np.int32)


def _collatz_jax(x0):
    def cond(s):
        return s[1]

    def body(s):
        x, _, it = s
        new = jnp.where(x == 1, 1, jnp.where(x % 2 == 0, x // 2, 3 * x + 1))
        return new, jnp.any(new != x), it + 1

    x, _, it = jax.lax.while_loop(cond, body, (jnp.asarray(x0),
                                               jnp.bool_(True), 0))
    return np.asarray(x), int(it)


def _collatz_body(s):
    x, _ = s
    new = torch.where(x == 1, 1, torch.where(x % 2 == 0, x // 2, 3 * x + 1))
    return new, (new != x).any()


@pytest.mark.parametrize("case", ["zero", "one", "many"])
def test_host_while_flag_matches_lax_while_loop(case):
    """An integer loop on a changed flag: the same values and the same
    bodies, including none (all ones) and one (ones after one step)."""
    x0 = {"zero": np.ones(8, np.int32), "one": np.array([2, 1, 2, 1],
                                                       np.int32),
          "many": _collatz_inputs()}[case]
    want_x, want_it = _collatz_jax(x0)
    got = host_while(_collatz_body, (torch.from_numpy(x0), True), Flag(1))
    # lax runs one body that changes nothing before its flag is false
    assert got.iterations == want_it == {"zero": 1, "one": 2}.get(
        case, want_it)
    np.testing.assert_array_equal(got.state[0].numpy(), want_x)
    assert got.host_reads == got.iterations and got.value is False
    none = host_while(_collatz_body, (torch.from_numpy(x0), False), Flag(1))
    assert none.iterations == 0 and none.host_reads == 0
    np.testing.assert_array_equal(none.state[0].numpy(), x0)


def _residual_jax(x0, c, max_iterations, tolerance):
    def cond(s):
        _, it, err = s
        return (it < max_iterations) & (err >= tolerance)

    def body(s):
        x, it, _ = s
        new = x * 0.5 + c
        return new, it + 1, jnp.max(jnp.abs(new - x))

    x, it, err = jax.lax.while_loop(
        cond, body, (jnp.asarray(x0), 0, jnp.float32(jnp.inf)))
    return np.asarray(x), int(it), float(err)


@pytest.mark.parametrize("max_iterations,tolerance,expect", [
    (0, 1e-3, 0), (1, 1e-3, 1), (40, 1e-3, None), (40, 0.0, 40),
    (40, 10.0, 1)])
def test_host_while_residual_matches_lax_while_loop(max_iterations,
                                                    tolerance, expect):
    """PageRank's condition: zero bodies, one, stopping by tolerance
    after a few, and at ``max_iterations``."""
    g = np.random.default_rng(11)
    x0 = g.random(200).astype(np.float32)
    c = g.random(200).astype(np.float32)
    want_x, want_it, want_err = _residual_jax(x0, jnp.asarray(c),
                                              max_iterations,
                                              np.float32(tolerance))
    c_t = torch.from_numpy(c)

    def body(s):
        x, _ = s
        new = x * 0.5 + c_t
        return new, torch.max(torch.abs(new - x))

    got = host_while(body, (torch.from_numpy(x0), float("inf")),
                     Residual(1, max_iterations, tolerance))
    assert got.iterations == want_it
    if expect is not None:
        assert want_it == expect
    else:
        assert 1 < want_it < max_iterations
    np.testing.assert_array_equal(got.state[0].numpy(), want_x)
    assert got.value == want_err
    # the residual is read each body when it can stop the loop, else once
    assert got.host_reads == (want_it if tolerance > 0 else
                              int(want_it > 0))


def test_device_while_on_cpu_runs_the_host_loop():
    """CPU tensors take the plain version; the nested form counts each
    loop's bodies; the card's loop refuses a CPU device and a machine
    without a card."""
    x0 = torch.from_numpy(_collatz_inputs(3))
    got = device_while(_collatz_body, (x0, True), Flag(1), cache={},
                       key="k")
    want = host_while(_collatz_body, (x0, True), Flag(1))
    assert torch.equal(got.state[0], want.state[0])
    assert (got.iterations, got.host_reads) == (want.iterations,
                                                want.host_reads) > (1, 1)

    def inner(s):
        x, i, j, more, go = s
        return x + 1, i, j + 1, j + 1 < 3, go

    def outer(s):
        x, i, j, more, go = s
        return x * 2, i + 1, torch.zeros_like(j), i + 1 > 0, i + 1 < 4

    z = torch.zeros((), dtype=torch.int32)
    nested = device_while((While(inner, Flag(3)), outer),
                          (torch.ones(3), z, z, True, True), Flag(4))
    assert nested.iterations == 4 and nested.inner == (12,)
    assert nested.state[0].tolist() == [106.0] * 3
    with pytest.raises(ValueError, match="CUDA device"):
        DeviceLoop(_collatz_body, (x0, True), Flag(1), torch.device("cpu"))
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        DeviceLoop(_collatz_body, (x0, True), Flag(1),
                   torch.device("cuda"))
    with pytest.raises(ValueError, match="state of 2"):
        host_while(lambda s: (s[0],), (x0, True), Flag(1))
    with pytest.raises(ValueError, match="at least one tensor"):
        device_while(_collatz_body, (1, True), Flag(1))


def test_two_buffers_from_the_state_size(monkeypatch):
    """A device loop pairs buffers for a one-step body whose state's
    largest tensor holds ``PAIR_MIN_BYTES``; never for a smaller state or
    a body of pieces (whose loops may nest)."""
    big = torch.zeros(loop.PAIR_MIN_BYTES // 4, dtype=torch.float32)
    small = torch.zeros(loop.PAIR_MIN_BYTES // 4 - 1, dtype=torch.float32)
    assert loop.two_buffers(_collatz_body, (big, True))
    assert not loop.two_buffers(_collatz_body, (small, 1.0, big[:8]))
    assert not loop.two_buffers((_collatz_body,), (big, True))
    assert not loop.two_buffers(While(_collatz_body, Flag(1)), (big, True))
    monkeypatch.setattr(loop, "PAIR_MIN_BYTES", 0)
    assert loop.two_buffers(_collatz_body, (torch.zeros(1), True))


def test_drivers_on_cuda_raise_without_a_card(monkeypatch):
    """A driver asked for the card on a machine without one raises (torch
    built for the CPU only asserts); it does not run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = gtt.build_directed([0, 1], [1, 2], device="cpu")
    with pytest.raises((RuntimeError, AssertionError)):
        gtt.wcc(g, device="cuda")
    assert loop.Flag(0).kind == 0 and loop.Residual(0, 1, 0.0).kind == 1


# ----------------------------------------------- drivers vs graph_tpu


def _pair(src, dst, n, values=None):
    jg = jax_build_directed(
        jnp.asarray(src.astype(np.int32)), jnp.asarray(dst.astype(np.int32)),
        values=None if values is None else jnp.asarray(values),
        node_count=n)
    tg = gtt.build_directed(src, dst, values, node_count=n, device="cpu")
    return jg, tg


def _rmat9():
    src, dst = host_rmat(9, seed=12)
    w = (np.random.default_rng(4).random(src.size) * 4).astype(np.float32)
    return src, dst, w, 1 << 9


@pytest.mark.parametrize("cfg,iterations", [
    ({"max_iterations": 0}, 0),
    ({"tolerance": 10.0}, 1),
    ({"tolerance": 1e-2}, None),
    ({"max_iterations": 12, "tolerance": 0.0}, 12),
    ({"max_iterations": 100, "tolerance": 1e-6}, None)],
    ids=["max0", "one", "few", "max", "converge"])
def test_page_rank_loop_stops_as_graph_tpu(cfg, iterations):
    """Stopping by tolerance after one iteration and after a few, at
    ``max_iterations``, and never (``max_iterations=0``, the initial
    scores): plan and cumsum bit-equal to graph_tpu's cumsum."""
    src, dst, _, n = _rmat9()
    jg, tg = _pair(src, dst, n)
    want = jax_page_rank(jg, JaxPrConfig(engine="cumsum", **cfg))
    if iterations is not None:
        assert want.ran_iterations == iterations
    else:
        assert 1 < want.ran_iterations < cfg["max_iterations"] if \
            "max_iterations" in cfg else 1 < want.ran_iterations < 20
    for engine in ("plan", "cumsum"):
        got = gtt.page_rank(tg, gtt.PageRankConfig(engine=engine, **cfg))
        assert got.ran_iterations == want.ran_iterations
        np.testing.assert_array_equal(got.scores_np(), want.scores_np())
        if want.ran_iterations == 0:
            assert got.error == want.error == float("inf")
            assert got.host_reads == 0
        else:
            assert abs(got.error - want.error) <= 1e-6


def test_wcc_loop_matches_graph_tpu():
    src, dst, _, n = _rmat9()
    keep = src % 7 != 0  # several components
    jg, tg = _pair(src[keep], dst[keep], n)
    want = jax_wcc(jg, JaxWccConfig(engine="xla"))
    for engine in ("plan", "xla"):
        got = gtt.wcc(tg, gtt.WccConfig(engine=engine))
        np.testing.assert_array_equal(got.components_np(),
                                      np.asarray(want.components))
        assert got.ran_iterations == want.ran_iterations >= 2
        assert got.host_reads == got.ran_iterations


def _settle_steps(dist, pending, delta, step):
    """The delta-stepping schedule as a plain Python loop over host
    values: its settle steps and distances."""
    delta = float(np.float32(delta))
    curr, steps = 0, 0
    while curr != sssp._NO_BIN:
        while True:
            frontier = pending & (sssp._bucket_of(dist, delta) == curr)
            if not bool(frontier.any()):
                break
            dist, pending = step(dist, pending, frontier)
            steps += 1
        curr = int(torch.where(pending, sssp._bucket_of(dist, delta),
                               sssp._NO_BIN).min())
    return dist, steps


@pytest.mark.parametrize("delta", [0.25, 3.0])
def test_sssp_loops_match_graph_tpu(delta, monkeypatch):
    """Bellman-Ford's rounds and delta-stepping's nested loops: every
    engine's distances equal graph_tpu's; the settle steps equal a plain
    Python walk over the buckets."""
    src, dst, w, n = _rmat9()
    start = int(np.bincount(src).argmax())
    jg, tg = _pair(src, dst, n, w)
    want = np.asarray(jax_delta_stepping(
        jg, JaxSsspConfig(start, delta, engine="xla")).distances)
    plan = gtt.delta_stepping(tg, gtt.DeltaSteppingConfig(start, delta,
                                                          engine="plan"))
    np.testing.assert_array_equal(plan.distances_np(), want)
    assert plan.host_reads == plan.ran_iterations >= 2

    seen = {}
    real = sssp._settle

    def spy(dist, pending, delta, step, **kw):
        seen["model"] = _settle_steps(dist.clone(), pending.clone(), delta,
                                      step)
        return real(dist, pending, delta, step, **kw)

    monkeypatch.setattr(sssp, "_settle", spy)
    for engine in ("xla", "frontier"):
        got = gtt.delta_stepping(tg, gtt.DeltaSteppingConfig(
            start, delta, engine=engine))
        np.testing.assert_array_equal(got.distances_np(), want)
        model_dist, model_steps = seen.pop("model")
        assert got.ran_iterations == model_steps >= 1
        assert torch.equal(got.distances, model_dist[:n])
        assert got.host_reads > got.ran_iterations
