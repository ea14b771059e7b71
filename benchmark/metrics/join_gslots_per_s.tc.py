"""Triangle count's join rate on the card: the wedge slots of the
``triangle_count.join`` spans (counter ``wedge_slots``) over their
CUDA-event time (``device_ms``), in billions a second; None without
CUDA events."""

from benchmark import spans


def read(run):
    timed = [s["counters"] for s in spans.named(spans.recorded(),
                                                "triangle_count.join")
             if "device_ms" in s["counters"]
             and "wedge_slots" in s["counters"]]
    ms = sum(c["device_ms"] for c in timed)
    if not timed or ms <= 0:
        return None
    return sum(c["wedge_slots"] for c in timed) / (ms * 1e-3) / 1e9
