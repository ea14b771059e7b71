"""Arithmetic of the per-layer metrics read from the program's own spans
(``source: "program_span"``): the spans ``graph_tpu_torch.profile``
recorded while the traced window ran (the profiler turns them on).

A program that records no spans (``graph_tpu_torch.profile`` without
``spans``), or no span of the kind a metric reads, gives None.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

#: The algorithm drivers' spans, whose counter ``rounds`` is the result's
#: ``ran_iterations``.
DRIVERS = ("page_rank.run", "wcc.run", "sssp.run")


def recorded() -> list:
    """The spans the program kept, as dicts (empty without any)."""
    from graph_tpu_torch import profile

    spans = getattr(profile, "spans", None)
    return spans() if callable(spans) else []


def duration_ms(span: dict) -> float:
    return (span["end_us"] - span["start_us"]) * 1e-3


def named(spans: Iterable[dict], *names: str) -> List[dict]:
    return [s for s in spans if s["name"] in names]


def mean_ms(spans: list, name: str) -> Optional[float]:
    """The mean duration of the spans called ``name``."""
    times = [duration_ms(s) for s in named(spans, name)]
    return sum(times) / len(times) if times else None


def self_ms(span: dict, spans: list) -> float:
    """A span's duration less its children's."""
    return duration_ms(span) - sum(duration_ms(s) for s in spans
                                   if s["parent"] == span["id"])


def per_request_ms(spans: list, *names: str,
                   own: bool = False) -> Optional[float]:
    """The mean over requests (the outermost spans) of the summed
    durations of their spans called one of ``names``, or with ``own``
    their self times."""
    sums: dict = {}
    for s in named(spans, *names):
        t = self_ms(s, spans) if own else duration_ms(s)
        sums[s["request"]] = sums.get(s["request"], 0.0) + t
    return sum(sums.values()) / len(sums) if sums else None


def loop_round_us(spans: list) -> Optional[float]:
    """The device loop's time a round on the card: the CUDA-event time of
    the ``loop.run`` spans inside a driver's span over the rounds of those
    drivers, in µs."""
    by_id = {s["id"]: s for s in spans}
    device_ms, drivers = 0.0, {}
    for s in named(spans, "loop.run"):
        if "device_ms" not in s["counters"]:
            continue
        up = by_id.get(s["parent"])
        while up is not None and up["name"] not in DRIVERS:
            up = by_id.get(up["parent"])
        if up is None or "rounds" not in up["counters"]:
            continue
        device_ms += s["counters"]["device_ms"]
        drivers[up["id"]] = up["counters"]["rounds"]
    rounds = sum(drivers.values())
    return device_ms / rounds * 1e3 if rounds else None


def gbps(spans: list, name: str) -> Optional[float]:
    """The summed ``bytes`` of the spans called ``name`` over their summed
    CUDA-event time, in GB/s."""
    timed = [s["counters"] for s in named(spans, name)
             if "device_ms" in s["counters"] and "bytes" in s["counters"]]
    ms = sum(c["device_ms"] for c in timed)
    if not timed or ms <= 0:
        return None
    return sum(c["bytes"] for c in timed) / (ms * 1e-3) / 1e9
