"""A ``torch.profiler`` trace of part of a run, read back from its file.

The device's busy time is the union of the device intervals (kernels,
copies, fills) inside the traced window.  Inside a conditional CUDA
graph CUPTI reports only part of the kernels, so busy time and
per-kernel sums there are lower bounds; a kernel's mean time over the
events it does report is not.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Dict, Iterator, List

import numpy as np
import torch

from benchmark.stats import gaps, union_length

#: Trace categories of device work: kernels, copies and fills.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: Trace categories of what the host was doing.
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "cuda_driver", "python_function")
#: The host-side region that spans the traced window.
WINDOW = "benchmark.trace_window"
#: Entries of each list of the breakdown.
TOP = 10


class Trace:
    """What one traced window held: ``window_s``, ``busy_s``, each device
    operation's durations by name (``durations``), and the host event
    that covered the middle of each of the longest idle gaps."""

    def __init__(self, events: List[dict]):
        window = [e for e in events if e.get("name") == WINDOW
                  and e.get("cat") == "user_annotation"]
        if not window:
            raise ValueError(f"no {WINDOW} region in the trace")
        start = float(window[0]["ts"])
        end = start + float(window[0]["dur"])
        device = []
        self.durations: Dict[str, List[float]] = {}
        for e in events:
            if e.get("cat") not in DEVICE_CATEGORIES:
                continue
            s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if t <= start or s >= end:
                continue
            device.append((max(s, start), min(t, end)))
            self.durations.setdefault(e["name"], []).append(
                float(e["dur"]) * 1e-6)
        self.window_s = (end - start) * 1e-6
        self.busy_s = union_length(device) * 1e-6
        host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                for e in events if e.get("cat") in HOST_CATEGORIES
                and e.get("name") != WINDOW]
        idle = sorted(gaps(device, start, end), key=lambda g: g[0] - g[1])
        self.idle_gaps = [[_host_at(host, (s + t) / 2), (t - s) * 1e-6]
                          for s, t in idle[:TOP]]

    def mean_s(self, match) -> float:
        """Mean duration of the device operations whose name ``match``
        accepts, or None where the trace reported none."""
        d = [x for name, xs in self.durations.items() if match(name)
             for x in xs]
        return sum(d) / len(d) if d else None

    def breakdown(self) -> dict:
        ops = sorted(((name, sum(xs)) for name, xs in self.durations.items()),
                     key=lambda kv: -kv[1])
        return {"device_ops": [[name[:200], s] for name, s in ops[:TOP]],
                "idle_gaps": self.idle_gaps}


def _host_at(host, t: float) -> str:
    """The innermost host event that covers time ``t``."""
    if not host:
        return "host: no event"
    s = np.fromiter((h[0] for h in host), float, len(host))
    e = np.fromiter((h[1] for h in host), float, len(host))
    cover = np.nonzero((s <= t) & (e >= t))[0]
    if cover.size == 0:
        return "host: no event"
    inner = cover[np.argmin(e[cover] - s[cover])]
    return f"host: {host[inner][2]}"[:200]


@contextlib.contextmanager
def traced() -> Iterator[list]:
    """Trace the enclosed block; the list it yields holds one
    :class:`Trace` once the block has ended.  The trace file is written
    under the temporary directory and removed once read."""
    out: list = []
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory(prefix="benchmark-trace-") as tmp:
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW):
                yield out
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and "dur" in e]
    out.append(Trace(events))
