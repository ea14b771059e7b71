"""Profiling hooks: a ``torch.profiler`` trace of a block, named regions
inside it, and the device's busy share read back from the trace file.

Counterpart of ``graph_tpu.profile`` (``trace``, ``annotate``), which
captures a ``jax.profiler`` trace; here the trace is a Chrome/Perfetto
JSON file (open it in ui.perfetto.dev or chrome://tracing):

    with graph_tpu_torch.profile.trace("traces") as log_dir:
        page_rank(g)            # each Jacobi iteration is annotated
    print(device_busy(newest_trace(log_dir))["busy_share"])
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import tempfile
import time
from pathlib import Path
from typing import Iterator, Optional

import torch

log = logging.getLogger(__name__)

#: Trace categories of device work: kernels, copies and fills.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_SUFFIX = ".pt.trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Capture a ``torch.profiler`` trace of the enclosed block.

    Records CPU activity, and CUDA activity when a card is available.
    On exit writes ``<log_dir>/graph_tpu_torch.<ns>.pt.trace.json``;
    ``log_dir`` (default ``graph_tpu_torch_trace`` in the temporary
    directory) is created if missing.  Yields the directory.
    """
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "graph_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log.info("capturing torch.profiler trace to %s", log_dir)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    path = os.path.join(log_dir,
                        f"graph_tpu_torch.{time.time_ns()}{TRACE_SUFFIX}")
    prof.export_chrome_trace(path)
    log.info("trace written to %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace (``torch.profiler.record_function``);
    free of the record's cost when no profiler is running."""
    if not torch._C._autograd._profiler_enabled():
        yield
        return
    with torch.profiler.record_function(name):
        yield


def newest_trace(log_dir: str) -> Path:
    """The most recently written trace file in ``log_dir``."""
    files = sorted(Path(log_dir).glob(f"*{TRACE_SUFFIX}"),
                   key=lambda p: p.stat().st_mtime_ns)
    if not files:
        raise FileNotFoundError(f"no *{TRACE_SUFFIX} in {log_dir}")
    return files[-1]


def device_busy(path, region: Optional[str] = None) -> dict:
    """The device's busy share over a trace's window, from its file.

    The window is the span of every timed event in the trace, or, given
    ``region``, that of the first host-side event of that name (an
    :func:`annotate` region; its copy on the device's timeline is not
    used).  Busy time is the union of the device intervals
    (:data:`DEVICE_CATEGORIES`) inside the window.  Returns
    ``window_us``, ``busy_us``, ``busy_share`` (0 without device events),
    ``device_us_by_name``, each device event name's summed time, largest
    first, and ``device_calls_by_name``, its count.
    """
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events]
    if region is not None:
        named = [s for e, s in zip(events, spans) if e.get("name") == region
                 and e.get("cat") != "gpu_user_annotation"]
        if not named:
            raise ValueError(f"no event named {region!r} in {path}")
        start, end = named[0]
    else:
        start = min((s for s, _ in spans), default=0.0)
        end = max((t for _, t in spans), default=0.0)
    device = sorted(
        (max(s, start), min(t, end), e["name"])
        for e, (s, t) in zip(events, spans)
        if e.get("cat") in DEVICE_CATEGORIES and t > start and s < end)
    busy, reach, by_name, calls = 0.0, start, {}, {}
    for s, t, name in device:
        busy += max(0.0, t - max(s, reach))
        reach = max(reach, t)
        by_name[name] = by_name.get(name, 0.0) + (t - s)
        calls[name] = calls.get(name, 0) + 1
    window = end - start
    return {"window_us": window, "busy_us": busy,
            "busy_share": busy / window if window > 0 else 0.0,
            "device_us_by_name": dict(sorted(by_name.items(),
                                             key=lambda kv: -kv[1])),
            "device_calls_by_name": calls}
