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


def test_import_pulls_in_no_jax():
    code = ("import sys, graph_tpu_torch, graph_tpu_torch.generate; "
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
        EdgeEngine, build_directed, build_undirected, csr_from_coo)
    from graph_tpu_torch.engine.plan import build_plan, plan_from_numpy

    src, dst = np.array([0, 1]), np.array([1, 2])
    calls = [
        lambda: build_directed(src, dst),
        lambda: build_undirected(src, dst),
        lambda: csr_from_coo(src, dst, node_count=3),
        lambda: EdgeEngine.build(src, dst, 3),
        lambda: build_plan(src, dst, 3),
        lambda: plan_from_numpy(src, dst, 3),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # asked for, the CPU works
    assert build_directed(src, dst, device="cpu").device.type == "cpu"
    assert build_undirected(src, dst, device="cpu").device.type == "cpu"
