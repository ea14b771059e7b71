"""graph_tpu_torch stands alone: no JAX, nothing of graph_tpu, no CPU
fallback it was not asked for."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "graph_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


#: Every module of the port, imported by name.
PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in (ROOT / "graph_tpu_torch").rglob("*.py"))


def test_import_pulls_in_no_jax():
    assert {"graph_tpu_torch.builder", "graph_tpu_torch.io.edgelist",
            "graph_tpu_torch.native.host_csr",
            "graph_tpu_torch.engine.loop"} <= set(PORT_MODULES)
    code = ("import importlib, sys\n"
            f"for name in {PORT_MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'graph_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_graph_tpu_import(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "graph_tpu"), (
                f"{path.name}:{node.lineno} imports {name}")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_device_or_card(no_card):
    from graph_tpu_torch import (
        CsrLayout, EdgeEngine, OocEdgeEngine, build_directed,
        build_undirected, build_undirected_host, csr_from_coo,
        global_triangle_count)
    from graph_tpu_torch.engine.ooc import (
        page_rank_ooc, sssp_ooc, wcc_ooc)
    from graph_tpu_torch.engine.plan import build_plan, plan_from_numpy

    src, dst = np.array([0, 1]), np.array([1, 2])
    host = build_undirected_host(src, dst, layout=CsrLayout.DEDUPLICATED)
    calls = [
        lambda: build_directed(src, dst),
        lambda: build_undirected(src, dst),
        lambda: csr_from_coo(src, dst, node_count=3),
        lambda: EdgeEngine.build(src, dst, 3),
        lambda: build_plan(src, dst, 3),
        lambda: build_plan(src, dst, 3, n_src=3),
        lambda: plan_from_numpy(src, dst, 3),
        lambda: OocEdgeEngine.build(src, dst, 3),
        lambda: page_rank_ooc(src, dst, 3),
        lambda: wcc_ooc(src, dst, 3),
        lambda: sssp_ooc(src, dst, np.ones(2, np.float32), 3),
        lambda: global_triangle_count(host),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # the device loop has no CPU mode: without a card it raises
    from graph_tpu_torch.engine.loop import DeviceLoop, Flag

    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        DeviceLoop(lambda s: s, (torch.zeros(2), True), Flag(1),
                   torch.device("cuda"))
    # asked for, the CPU works
    assert build_directed(src, dst, device="cpu").device.type == "cpu"
    assert build_undirected(src, dst, device="cpu").device.type == "cpu"


def test_port_opens_nothing_of_the_jax_side(tmp_path):
    """Building the host C++, parsing, building on the host, writing and
    reading a snapshot, counting triangles (the native orientation), the
    segment-op engines and the out-of-core engine open no file, and start
    no compiler on a file, under the repository's root ``native/`` or
    ``graph_tpu/``: the port compiles its own copies."""
    code = f"""
import os, sys
seen = []
sys.addaudithook(lambda event, args: seen.append((event, args))
                 if event in ("open", "subprocess.Popen") else None)
import pathlib
import graph_tpu_torch as gtt
from graph_tpu_torch.native import build
build.BUILD_DIR = pathlib.Path({str(tmp_path)!r}) / "build"  # compile here
el = os.path.join({str(tmp_path)!r}, "g.el")
open(el, "w").write("0 1\\n1 2\\n2 0\\n")
g = gtt.GraphBuilder().path(el).build_undirected(host=True)
snap = os.path.join({str(tmp_path)!r}, "g.bin")
gtt.save_graph(snap, g)
gtt.load_graph(snap, device="cpu")
tg = gtt.build_undirected([0, 1, 2, 2], [1, 2, 0, 3], device="cpu",
                          layout=gtt.CsrLayout.DEDUPLICATED)
assert gtt.global_triangle_count(tg).triangles == 1
from graph_tpu_torch.native import host_csr
assert host_csr.load_error() is None
dg = gtt.build_directed([0, 1, 2], [1, 2, 0], [1.0, 2.0, 3.0], device="cpu")
gtt.page_rank(dg, gtt.PageRankConfig(engine="cumsum"))
gtt.wcc(dg, gtt.WccConfig(engine="xla"))
for engine in ("xla", "frontier"):
    gtt.delta_stepping(dg, gtt.DeltaSteppingConfig(0, 1.0, engine=engine))
from graph_tpu_torch.engine.ooc import wcc_ooc
assert wcc_ooc([0, 1], [1, 2], 4, device="cpu").tolist() == [0, 0, 0, 3]
paths, compiled = [], 0
for event, args in seen:
    items = args[1] if event == "subprocess.Popen" else [args[0]]
    items = [os.path.realpath(str(a)) for a in items or ()
             if isinstance(a, (str, os.PathLike))]
    compiled += event == "subprocess.Popen" and any(
        a.endswith(".cpp") for a in items)
    paths += items
print(compiled, "sources compiled")
for p in paths:
    print(p)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == "2 sources compiled", r.stdout
    forbidden = [str(ROOT / "native"), str(ROOT / "graph_tpu")]
    for p in lines[1:]:
        assert not any(p == f or p.startswith(f + os.sep)
                       for f in forbidden), p
    assert any(p.startswith(str(ROOT / "graph_tpu_torch" / "native"))
               and p.endswith(".cpp") for p in lines[1:])
