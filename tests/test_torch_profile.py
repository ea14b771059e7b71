"""graph_tpu_torch.profile: a torch.profiler trace around a CPU PageRank,
its annotated regions, and the device busy share read from a trace."""

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
    # no card: the window is the CPU's, and nothing ran on a device
    busy = profile.device_busy(path, region="whole_run")
    assert busy["window_us"] > 0 and busy["busy_us"] == 0.0
    assert busy["busy_share"] == 0.0 and busy["device_us_by_name"] == {}
    assert busy["device_calls_by_name"] == {}


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


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0, "tid": 0}


def test_device_busy_on_a_hand_made_trace(tmp_path):
    events = [
        _event("run", "gpu_user_annotation", 80.0, 200.0),  # not a window
        _event("run", "user_annotation", 100.0, 100.0),   # window 100-200
        _event("launch", "cuda_runtime", 90.0, 5.0),
        _event("k1", "kernel", 110.0, 30.0),              # 110-140
        _event("k2", "kernel", 130.0, 20.0),              # overlaps: to 150
        _event("copy", "gpu_memcpy", 160.0, 10.0),        # 160-170
        _event("fill", "gpu_memset", 195.0, 20.0),        # cut at 200
        _event("k1", "kernel", 250.0, 10.0),              # outside
        {"ph": "i", "name": "marker", "ts": 300.0},       # not timed
        {"ph": "f", "name": "flow", "ts": 50.0, "id": 1},
    ]
    path = tmp_path / "hand.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    run = profile.device_busy(path, region="run")
    assert run["window_us"] == 100.0
    assert run["busy_us"] == 40.0 + 10.0 + 5.0
    assert run["busy_share"] == pytest.approx(0.55)
    assert run["device_us_by_name"] == {"k1": 30.0, "k2": 20.0,
                                        "copy": 10.0, "fill": 5.0}
    assert run["device_calls_by_name"] == {"k1": 1, "k2": 1, "copy": 1,
                                           "fill": 1}
    whole = profile.device_busy(path)  # 80 to 280
    assert whole["window_us"] == 200.0
    assert whole["device_calls_by_name"]["k1"] == 2
    assert whole["busy_us"] == 40.0 + 10.0 + 20.0 + 10.0
    assert list(whole["device_us_by_name"]) == ["k1", "k2", "fill", "copy"]
    with pytest.raises(ValueError, match="no event named"):
        profile.device_busy(path, region="missing")
