"""A run with the timed path broken underneath reads ``correct`` false.

Each test skips the look for a card (the harness runs on the CPU, at the
small sizes of ``conftest.SMALL``) and drives the rest of a run of each
cell with one fault planted in the port:

* ``unchanged``: every loop's step returns its state unchanged;
* ``half``: half of the edges are left out of every plan the engines
  build (the sums, minima and labels over the rest);
* ``few``: one edge in twenty is left out the same way;
* ``altered``: one value of each answer is altered where the program
  produces it.

The exchange between chips is no fault these cells can have: each runs
on one chip.  The test without a fault shows the same runs read true.
The card test plants ``few``, the smallest of these faults, at the
cells' own size on three seeds and prints what each run read.
"""

import dataclasses

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import load_bench
from graph_tpu_torch import api
from graph_tpu_torch.algos import pagerank, sssp
from graph_tpu_torch.engine import engine, loop

wcc_mod = __import__("graph_tpu_torch.algos.wcc", fromlist=["wcc"])

CELLS = ["graph500-s22.pagerank", "graph500-s22.wcc", "graph500-s22.sssp",
         "graph500-s22.ingest"]


def _unchanged(monkeypatch):
    def device_while(body, state, cond, **_):
        return loop.Loop(state=tuple(state), iterations=1, value=0,
                         host_reads=1)
    for mod in (pagerank, wcc_mod, sssp):
        monkeypatch.setattr(mod, "device_while", device_while)


def _leave_out(monkeypatch, every: int):
    """Every plan built without the edges whose position is a multiple
    of ``every``."""
    build = engine.load_or_build_plan

    def kept(x, keep):
        if x is None:
            return None
        return x[keep.to(x.device)] if torch.is_tensor(x) else x[keep.numpy()]

    def fewer(src, dst, n, *, values=None, **kw):
        keep = torch.arange(len(src)) % every != 0
        return build(kept(src, keep), kept(dst, keep), n,
                     values=kept(values, keep), **kw)
    monkeypatch.setattr(engine, "load_or_build_plan", fewer)


def _half(monkeypatch):
    _leave_out(monkeypatch, 2)


def _few(monkeypatch):
    _leave_out(monkeypatch, 20)


def _altered(monkeypatch):
    def alter(field, change):
        """The answer's middle entry, or its largest finite one for
        distances (a node that is reached), changed by ``change``."""
        def wrap(fn):
            def run(*args, **kw):
                res = fn(*args, **kw)
                value = getattr(res, field).clone()
                k = value.numel() // 2
                if field == "distances":
                    finite = torch.where(value < sssp.INF, value, -1.0)
                    k = int(torch.argmax(finite))
                value[k] = change(value[k])
                return dataclasses.replace(res, **{field: value})
            return run
        return wrap

    scores = alter("scores", lambda v: v * 1.5)
    monkeypatch.setattr(api, "page_rank", scores(pagerank.page_rank))
    monkeypatch.setattr(pagerank, "page_rank", scores(pagerank.page_rank))
    monkeypatch.setattr(wcc_mod, "wcc", alter(
        "components", lambda v: v + 1)(wcc_mod.wcc))
    monkeypatch.setattr(sssp, "delta_stepping", alter(
        "distances", lambda v: v * 1.01 + 0.01)(sssp.delta_stepping))


FAULTS = {"unchanged": _unchanged, "half": _half, "few": _few,
          "altered": _altered}


def _run(small, workload):
    bench, reg = small
    return harness.run_cell(bench, workload, 2**31 + 77, 0.3, False,
                            device=torch.device("cpu"), registry=reg)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_read_correct(small, workload):
    res = _run(small, workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_reads_not_correct(small, monkeypatch, workload,
                                               fault):
    FAULTS[fault](monkeypatch)
    res = _run(small, workload)
    assert not res["correct"], res["checks"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", CELLS[:3])
def test_a_few_edges_left_out_read_not_correct_on_the_card(card, monkeypatch,
                                                           workload):
    _few(monkeypatch)
    bench = load_bench()
    for seed in (2**31 + 21, 2**31 + 22, 2**31 + 23):
        res = harness.run_cell(bench, workload, seed, 3.0, False,
                               device=card)
        print(workload, seed, {k: c["value"] for k, c in
                               res["checks"].items()})
        assert not res["correct"], res["checks"]
