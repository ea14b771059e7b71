"""Fixtures of the benchmark's own tests: a copy of the benchmark folder
whose configuration is cut to a size the CPU runs in seconds, and
the card, looked for inside a fixture."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import harness  # noqa: E402

#: The small size: Graph500 at scale 9.
SMALL = {"graph500-s22": {"scale": 9, "n": 512, "m": 8192}}


def load_bench() -> dict:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def small_copy(dest: Path, sizes=SMALL) -> harness.Registry:
    """A copy of ``benchmark/`` at ``dest`` with ``sizes`` written over
    the configurations' keys; its registry."""
    shutil.copytree(REPO / "benchmark", dest,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, keys in sizes.items():
        path = dest / "configs" / f"{name}.json"
        config = json.loads(path.read_text())
        config.update(keys)
        path.write_text(json.dumps(config))
    return harness.Registry(dest)


@pytest.fixture
def small(tmp_path):
    """(BENCHMARK.json, a registry over the small copy)."""
    return load_bench(), small_copy(tmp_path / "benchmark")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
