"""The control comes out not correct: the plain reference put in the
program's place and computed one precision below what the
configurations state (bfloat16 scores and distances, int16 labels).

On the CPU it runs at a size a test run holds (65,536 nodes, so that
int16 labels wrap); the card test runs it at the cells' own size on
three seeds, as ``benchmark/calibrate.py`` does."""

import pytest

from benchmark import harness
from benchmark.tests.conftest import load_bench, small_copy

CELLS = ["graph500-s22.pagerank", "graph500-s22.wcc", "graph500-s22.sssp",
         "graph500-s22.ingest"]
#: Graph500 at scale 16.
MEDIUM = {"graph500-s22": {"scale": 16, "n": 1 << 16, "m": 16 << 16}}


def _control_fails(res, cell):
    checks = harness.judge(cell, res["control_numbers"])
    return any(c["value"] > c["limit"] for c in checks.values())


@pytest.fixture(scope="module")
def medium(tmp_path_factory):
    return load_bench(), small_copy(tmp_path_factory.mktemp("b") /
                                    "benchmark", MEDIUM)


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_reads_not_correct(medium, workload):
    bench, reg = medium
    res = harness.run_cell(bench, workload, 2**31 + 5, 0.3, False,
                           device="cpu", registry=reg, control=True)
    assert res["correct"], res["checks"]
    cell = harness.Cell(bench, workload, 0, None, reg)
    assert _control_fails(res, cell), res["control_numbers"]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_reads_not_correct_on_the_card(card, workload):
    bench = load_bench()
    reg = harness.Registry()
    cell = harness.Cell(bench, workload, 0, card, reg)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        res = harness.run_cell(bench, workload, seed, 3.0, False,
                               device=card, registry=reg, control=True)
        assert res["correct"], res["checks"]
        assert _control_fails(res, cell), res["control_numbers"]
