"""The multi-device and out-of-core drivers run their rounds through
``engine.loop.host_while``: each run records one ``loop.run`` span whose
``bodies`` are the driver's rounds and whose ``host_reads`` are the
result's (the sharded drivers) or one a round (the out-of-core drivers,
which return only their answer), and whose ``launches`` are the kernel
launches the run added.

Small graphs on the CPU: a mesh of four shards, two slabs out of core.
"""

import numpy as np
import pytest
import torch

import graph_tpu_torch as gtt
from graph_tpu_torch import profile
from graph_tpu_torch.engine import kernels, ooc
from graph_tpu_torch.generate import uniform_edge_list
from graph_tpu_torch.parallel import pagerank as tpp
from graph_tpu_torch.parallel import sssp as tps
from graph_tpu_torch.parallel import wcc as tpw
from graph_tpu_torch.parallel.mesh import Mesh

MESH = Mesh([torch.device("cpu")] * 4)


@pytest.fixture(autouse=True)
def empty_buffer():
    profile.spans(clear=True)
    yield
    profile.spans(clear=True)


def _edges(n=400, m=2400, seed=21):
    src, dst = uniform_edge_list(n, m, seed=seed)
    w = (np.random.default_rng(seed).random(m) * 3).astype(np.float32)
    return src, dst, w, n


def _sharded(name):
    """A sharded driver's run: (rounds, host reads)."""
    src, dst, w, n = _edges()
    g = gtt.build_directed(src, dst, w, node_count=n, device="cpu")
    if name == "pagerank":
        res = tpp.page_rank_sharded(tpp.shard_graph(g, MESH), MESH,
                                    gtt.PageRankConfig(tolerance=1e-6))
    elif name == "wcc":
        res = tpw.wcc_sharded(tpw.shard_hook_graph(g, MESH), MESH)
    else:
        res = tps.sssp_sharded(tps.shard_weighted_graph(g, MESH), MESH,
                               gtt.DeltaSteppingConfig(0, 2.0))
    return res.ran_iterations, res.host_reads


def _out_of_core(name, monkeypatch):
    """An out-of-core driver's run: (rounds, host reads), its rounds the
    calls of the engine op it runs once a round."""
    src, dst, w, n = _edges()
    op = "smin_int" if name == "wcc_ooc" else "relax"
    calls = []
    real = getattr(ooc.OocEdgeEngine, op)

    def counted(self, x):
        calls.append(1)
        return real(self, x)

    monkeypatch.setattr(ooc.OocEdgeEngine, op, counted)
    if name == "wcc_ooc":
        ooc.wcc_ooc(src, dst, n, n_slabs=2, device="cpu")
    else:
        ooc.sssp_ooc(src, dst, w, n, 0, n_slabs=2, device="cpu")
    return len(calls), len(calls)


@pytest.mark.parametrize("name", ["pagerank", "wcc", "sssp", "wcc_ooc",
                                  "sssp_ooc"])
def test_driver_rounds_run_through_host_while(name, monkeypatch):
    before = dict(kernels.LAUNCHES)
    with profile.record():
        if name.endswith("_ooc"):
            rounds, reads = _out_of_core(name, monkeypatch)
        else:
            rounds, reads = _sharded(name)
    grown = {k: v - before[k] for k, v in kernels.LAUNCHES.items()
             if v != before[k]}
    run, = (s for s in profile.spans() if s["name"] == "loop.run")
    c = run["counters"]
    assert rounds > 1
    assert c["bodies"] == [rounds] and c["host_reads"] == reads
    assert c["launches"] == grown
