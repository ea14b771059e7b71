"""graph_tpu_torch.profile: a torch.profiler trace around a CPU PageRank,
and its annotated regions in the trace and among the recorded spans."""

import inspect
import json

import numpy as np
import pytest
import torch

import graph_tpu.profile as jax_profile
import graph_tpu_torch as gtt
from graph_tpu_torch import profile
from graph_tpu_torch.algos.pagerank import ITERATION


def test_same_surface_as_graph_tpu():
    for name in ("trace", "annotate"):
        assert (inspect.signature(getattr(profile, name)).parameters.keys()
                == inspect.signature(getattr(jax_profile, name))
                .parameters.keys())


def test_trace_writes_a_file_with_the_annotations(tmp_path):
    # spans an earlier test left in the process-wide buffer are not ours
    profile.spans(clear=True)
    g = np.random.default_rng(4)
    src, dst = g.integers(0, 64, 400), g.integers(0, 64, 400)
    graph = gtt.build_directed(src, dst, node_count=64, device="cpu")
    cfg = gtt.PageRankConfig(max_iterations=3, tolerance=0.0)
    with profile.trace(str(tmp_path)) as log_dir:
        assert log_dir == str(tmp_path)
        with profile.annotate("whole_run"):
            res = gtt.page_rank(graph, cfg)
    assert res.ran_iterations == 3
    path = profile.newest_trace(log_dir)
    assert path.parent == tmp_path and path.name.endswith(".pt.trace.json")
    names = [e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]]
    assert names.count(ITERATION) == 3 and names.count("whole_run") == 1
    # the same regions among the spans the trace recorded, nested
    spans = profile.spans(clear=True)
    whole, = (s for s in spans if s["name"] == "whole_run")
    iterations = [s for s in spans if s["name"] == ITERATION]
    assert len(iterations) == 3
    assert all(s["request"] == whole["id"] for s in iterations)
    assert whole["start_us"] < min(s["start_us"] for s in iterations)
    assert whole["end_us"] > max(s["end_us"] for s in iterations)


def test_trace_default_directory_and_no_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr("tempfile.tempdir", None)
    with profile.trace() as log_dir:
        torch.ones(4).sum()
    assert log_dir == str(tmp_path / "graph_tpu_torch_trace")
    assert profile.newest_trace(log_dir).exists()
    with pytest.raises(FileNotFoundError):
        profile.newest_trace(str(tmp_path))
    with profile.annotate("outside a trace"):  # a no-op
        pass
