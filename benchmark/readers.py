"""Arithmetic the metric readers share (``metrics/<name>.py``)."""

from __future__ import annotations

from typing import Callable, Optional

from benchmark import work
from benchmark.stats import union_length


def gevps(run) -> float:
    """LDBC Graphalytics' EVPS, in billions: the edges plus vertices of
    the input graph of every request the window completed, over the
    window."""
    return sum(r.work for r in run.of()) / run.window_s / 1e9


def idle_pct(run) -> Optional[float]:
    """The share of the window in which no request was on the card, in
    %: one less the union of the requests' CUDA-event intervals (an event
    before each call, one after its answer reached the host) over the
    window.  Gaps inside a request count as busy."""
    if not run.records:
        return None
    spans = [(r.device["start"], r.device["end"]) for r in run.records]
    window = max(e for _, e in spans) - run.records[0].device["start"]
    return (1.0 - union_length(spans) / window) * 100.0


def round_us(records: list) -> Optional[float]:
    """The program's own time per round: the results' summed ``micros``
    over their summed iterations."""
    rounds = sum(r.iterations or 0 for r in records)
    if not records or rounds == 0:
        return None
    return sum(r.micros for r in records) / rounds


def mean_ms(values: list) -> Optional[float]:
    return sum(values) / len(values) * 1e3 if values else None


def kernel_roofline(run, op: str, nbytes: Callable[[int, int], int],
                    *matches: Callable[[str], bool]) -> Optional[float]:
    """A kernel's share of its bound, in %, in a cell whose kernels of
    that name all serve ``op``'s graph: its byte count over the HBM
    bandwidth, divided by the summed mean durations of the device
    functions one call launches (one ``match`` each), as the traced
    window reported them.  None without a trace, a request of ``op`` or
    an event of each function."""
    records = run.of(op)
    if run.trace is None or not records:
        return None
    means = [run.trace.mean_s(match) for match in matches]
    if any(m is None for m in means):
        return None
    r = records[0]
    return work.bound_s(nbytes(r.nodes, r.edges)) / sum(means) * 100.0
