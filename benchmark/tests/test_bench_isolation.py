"""Nothing the benchmark runs imports JAX or the JAX package, and
neither the plain reference nor the kinds of answer import anything of
the port.

Names are compared by their top-level part, whole: ``graph_tpu_torch``
is the port, and allowed outside ``benchmark/reference/`` and
``benchmark/kinds/``."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.tests.conftest import REPO

BENCH = REPO / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "graph_tpu"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_file_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"
    if {"reference", "kinds"} & set(path.relative_to(BENCH).parts):
        assert "graph_tpu_torch" not in tops, f"{path} imports the port"


def _loaded_after(code):
    """Top-level names in ``sys.modules`` after ``code`` runs, in a fresh
    interpreter at the repo root."""
    probe = (code + "\nimport json, sys\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in "
             "list(sys.modules)})))")
    r = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.splitlines()[-1]))


def test_everything_a_run_loads_is_free_of_jax():
    """run.py, the harness, every op, kind of answer, generator and metric
    reader, and the reference, loaded by name as a run loads them."""
    code = (
        "import benchmark.run, benchmark.calibrate\n"
        "from benchmark import harness\n"
        "import benchmark.reference.pagerank, benchmark.reference.wcc, "
        "benchmark.reference.sssp\n"
        "reg = harness.Registry()\n"
        "for folder in ('ops', 'kinds', 'generators', 'metrics'):\n"
        "    for p in sorted((reg.root / folder).glob('*.py')):\n"
        "        if p.stem != '__init__':\n"
        "            reg.module(folder, p.stem)\n")
    loaded = _loaded_after(code)
    assert "graph_tpu_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded_after(
        "import benchmark.reference.pagerank, benchmark.reference.wcc, "
        "benchmark.reference.sssp, benchmark.kinds.page_rank, "
        "benchmark.kinds.wcc, benchmark.kinds.sssp")
    assert not loaded & (FORBIDDEN | {"graph_tpu_torch"})


def test_run_names_a_forbidden_module_by_its_whole_top_level_name(
        monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "graph_tpu_torch_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_without_a_card_or_the_port_a_run_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, and on a machine without a card, run.py exits non-zero and
    prints nothing on standard output."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (tmp_path, REPO):
        r = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "graph500-s22.pagerank", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert r.returncode != 0 and r.stdout == "", (cwd, r.stdout)
