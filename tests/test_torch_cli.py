"""graph_tpu_torch.cli against graph_tpu.cli, in-process, on the same files.

Mirrors tests/test_cli.py test for test, with inputs made here from
seeds (tests/test_torch_api.py's ``write_inputs``).  Both CLIs run with
``caplog`` on; their result lines (PageRank iterations and error,
triangles, loaded counts, the serialize round trip) must be equal, and
so must the sequence of their log lines' templates.  The port runs with
``--platform cpu``.
"""

import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from graph_tpu.algos import triangle_count as jtc
from graph_tpu.cli import main as jax_main
from graph_tpu_torch.cli import main
from graph_tpu_torch.engine import tc_join
from graph_tpu_torch.engine.plan import PLAN_CACHE_ENV

from test_torch_api import write_inputs

ROOT = Path(__file__).resolve().parents[1]
PORT_LOG, JAX_LOG = "graph_tpu_torch.app", "graph_tpu.app"
#: graph_tpu_torch's result lines; the other lines carry timings.
RESULTS = ("PageRank ran", "Computed", "Loaded", "Serialization roundtrip")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_inputs(tmp_path_factory.mktemp("cli"))


@pytest.fixture(autouse=True)
def small_slab(monkeypatch):
    """graph_tpu pads each triangle join step to 2**25 wedge slots."""
    monkeypatch.setattr(jtc, "SLAB", 1 << 20)
    monkeypatch.setattr(tc_join, "SLAB", 1 << 12)


def run(argv):
    return main(argv + ["--platform", "cpu"])


def logged(caplog, name):
    """(templates, result lines) logged by one CLI, in order; graph_tpu's
    note on its 32-bit id default (JAX's x64 gate) is left out."""
    recs = [r for r in caplog.records if r.name == name
            and not r.msg.startswith("ids default to 32-bit")]
    return ([r.msg for r in recs],
            [r.getMessage() for r in recs if r.msg.startswith(RESULTS)])


def both(caplog, argv):
    """Run both CLIs on ``argv``; their result lines, which must match."""
    caplog.set_level(logging.INFO)
    caplog.clear()
    assert jax_main(argv) == 0
    want_templates, want = logged(caplog, JAX_LOG)
    caplog.clear()
    assert run(argv) == 0
    templates, got = logged(caplog, PORT_LOG)
    assert templates == want_templates
    assert got == want
    return got


def test_page_rank_cli(caplog, paths):
    lines = both(caplog, ["page-rank", "-p", paths[1], "-r", "1", "-w", "1"])
    assert len(lines) == 2 and lines[0].startswith("PageRank ran ")
    both(caplog, ["page-rank", "-p", paths[0], "-f", "graph500", "-r", "1",
                  "-w", "0", "--max-iterations", "7"])


def test_sssp_cli(caplog, paths):
    both(caplog, ["sssp", "-p", paths[2], "-r", "1", "-w", "0",
                  "--start-node", "0", "--delta", "2.0"])


def test_wcc_cli(caplog, paths):
    both(caplog, ["wcc", "-p", paths[1], "-r", "1", "-w", "0"])


def test_triangle_count_cli(caplog, paths):
    for relabel in ([], ["--relabel"]):
        lines = both(caplog, ["triangle-count", "-p", paths[0], "-f",
                              "graph500", "-r", "1", "-w", "0", *relabel])
        assert lines[0].startswith("Computed ") and lines[0] != "Computed 0 triangles"


def test_loading_cli(caplog, paths):
    lines = both(caplog, ["loading", "-p", paths[1], "-r", "2", "-w", "0"])
    assert lines == ["Loaded 64 nodes and 256 edges"] * 2
    both(caplog, ["loading", "-p", paths[2], "-r", "1", "-w", "0",
                  "--undirected", "--weighted"])


def test_serialize_cli(caplog, paths, tmp_path):
    out, jout = str(tmp_path / "g.bin"), str(tmp_path / "jg.bin")
    caplog.set_level(logging.INFO)
    assert jax_main(["serialize", "-p", paths[1], "-o", jout, "-r", "1",
                     "-w", "0"]) == 0
    for ids in ([], ["--use-32-bit"]):
        caplog.clear()
        assert run(["serialize", "-p", paths[1], "-o", out, "-r", "1",
                    "-w", "0", *ids]) == 0
        assert logged(caplog, PORT_LOG)[1] == [
            "Serialization roundtrip verified"]
    # 32-bit ids: the same snapshot bytes as graph_tpu's (its CPU default)
    assert Path(out).read_bytes() == Path(jout).read_bytes()


def test_missing_subcommand():
    for entry in (jax_main, main):
        with pytest.raises(SystemExit) as exc:
            entry([])
        assert exc.value.code == 2


def test_adjacency_list_cli(caplog, paths):
    csr = both(caplog, ["page-rank", "-p", paths[1], "-r", "1", "-w", "0"])
    al = both(caplog, ["page-rank", "-p", paths[1], "-g", "adjacency-list",
                       "-r", "1", "-w", "0"])
    assert al == csr


def test_adjacency_list_loads_al_graph(paths):
    from graph_tpu.cli import _load as jax_load
    from graph_tpu.cli import build_parser as jax_parser
    from graph_tpu_torch.cli import _load, build_parser
    from graph_tpu_torch.graph.csr import DirectedCsrGraph

    base = ["wcc", "-p", paths[1], "--platform", "cpu"]
    g_al = _load(build_parser().parse_args(base + ["-g", "adjacency-list"]))
    g_csr = _load(build_parser().parse_args(base))
    j_al = jax_load(jax_parser().parse_args(
        ["wcc", "-p", paths[1], "-g", "adjacency-list"]))
    assert isinstance(g_al, DirectedCsrGraph)
    assert (g_al.node_count, g_al.edge_count) == (g_csr.node_count,
                                                  g_csr.edge_count)
    for csr in ("csr_out", "csr_in"):
        offsets = getattr(g_al, csr).offsets
        assert torch.equal(offsets, getattr(g_csr, csr).offsets)
        np.testing.assert_array_equal(offsets.numpy(),
                                      np.asarray(getattr(j_al, csr).offsets))


def test_use_32_bit_flag_switches_id_dtype(paths):
    from graph_tpu_torch.cli import _id_dtype, _load, build_parser

    base = ["wcc", "-p", paths[1], "--platform", "cpu"]
    args32 = build_parser().parse_args(base + ["--use-32-bit"])
    args64 = build_parser().parse_args(base)
    assert _id_dtype(args32) == np.int32
    assert _id_dtype(args64) == np.int64  # the reference's usize default
    assert _load(args32).csr_out.targets.dtype == torch.int32
    assert _load(args64).csr_out.targets.dtype == torch.int64


def test_profile_flag_writes_trace(paths, tmp_path):
    d = tmp_path / "trace"
    assert run(["page-rank", "-p", paths[1], "-r", "1", "-w", "1",
                "--profile", str(d)]) == 0
    assert list(d.glob("*.pt.trace.json")), "no trace files captured"


def test_verbose_once_keeps_device_loop(paths, monkeypatch):
    """A single -v must not enable log_progress (a host read every
    iteration); only -v -v does, as in graph_tpu's CLI."""
    seen = {}

    def fake_page_rank(g, cfg):
        seen["log_progress"] = cfg.log_progress

        class R:
            ran_iterations = 1
            error = 0.0
        return R()

    import graph_tpu_torch.algos.pagerank as pr
    monkeypatch.setattr(pr, "page_rank", fake_page_rank)
    run(["page-rank", "-p", paths[1], "-r", "1", "-w", "0", "-v"])
    assert seen["log_progress"] is False
    run(["page-rank", "-p", paths[1], "-r", "1", "-w", "0", "-v", "-v"])
    assert seen["log_progress"] is True


# -- the port's own: --platform, --plan-cache, python -m -------------------


def test_platform_default_raises_without_card(paths, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for platform in ([], ["--platform", "default"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["wcc", "-p", paths[1], "-r", "1", "-w", "0", *platform])
    assert run(["wcc", "-p", paths[1], "-r", "1", "-w", "0"]) == 0


def test_plan_cache_flag(paths, tmp_path, monkeypatch):
    monkeypatch.delenv(PLAN_CACHE_ENV, raising=False)
    cache = tmp_path / "plans"
    argv = ["page-rank", "-p", paths[1], "-r", "1", "-w", "0",
            "--plan-cache", str(cache)]
    assert run(argv) == 0
    assert os.environ[PLAN_CACHE_ENV] == str(cache)
    plans = sorted(cache.glob("torchplan-*.npz"))
    assert len(plans) == 1
    stamp = plans[0].stat().st_mtime_ns
    assert run(argv) == 0  # a hit: the snapshot is not written again
    assert sorted(cache.glob("torchplan-*.npz")) == plans
    assert plans[0].stat().st_mtime_ns == stamp


def test_python_dash_m(paths):
    r = subprocess.run(
        [sys.executable, "-m", "graph_tpu_torch.cli", "loading", "-p",
         paths[1], "-r", "1", "-w", "0", "--platform", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stderr
    assert "Loaded 64 nodes and 256 edges" in r.stderr
