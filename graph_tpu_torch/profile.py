"""Profiling hooks: a ``torch.profiler`` trace of a block, and the spans
and counters the port records at its layer boundaries.

Counterpart of ``graph_tpu.profile`` (``trace``, ``annotate``), which
captures a ``jax.profiler`` trace; here the trace is a Chrome/Perfetto
JSON file (open it in ui.perfetto.dev or chrome://tracing).

A span (:func:`span`) is a named, timed region with counters.  Spans are
on while ``torch.profiler`` records, or inside :func:`record`; off, a
span costs one check and records nothing.  While on, each span is also a
``record_function`` range, so it appears in an exported trace as a
``user_annotation`` event on the clock of the card's events, and it is
kept in a bounded buffer that :func:`spans` returns:

    with graph_tpu_torch.profile.record():
        page_rank(g)
    for s in graph_tpu_torch.profile.spans(clear=True):
        print(s["name"], s["end_us"] - s["start_us"], s["counters"])

Every span records its name, start and end (µs, in the trace's time
base: :data:`BASE_NS` less than Unix time), its id, its parent's id
(the span open on the same thread when it opened), its request (the id
of the outermost span open on its thread), its thread and its counters.
A span that times work on the card either ends at a host read that
already waits for that work, or carries CUDA events
(:meth:`Span.cuda_events`), read once :func:`spans` is called; no span
waits for the card.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import tempfile
import threading
import time
from collections import deque
from pathlib import Path
from typing import Iterator, Optional

import torch

log = logging.getLogger(__name__)

TRACE_SUFFIX = ".pt.trace.json"
#: The most spans the buffer keeps; older ones are dropped first.
LIMIT = 1 << 16
#: The trace's time base: Unix time rounded down to a multiple of
#: 7,889,238 s (a quarter of a year), as the profiler's exporter writes
#: it in ``baseTimeNanoseconds``.  A span's times are µs after it.
BASE_NS = int(time.time()) // 7_889_238 * 7_889_238 * 1_000_000_000
#: Unix time less ``perf_counter``, in ns, measured once.
_OFFSET_NS = time.time_ns() - time.perf_counter_ns()

_profiler_enabled = torch._C._autograd._profiler_enabled
_recording = 0
_spans: deque = deque()
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()


def _now_us() -> float:
    return (time.perf_counter_ns() + _OFFSET_NS - BASE_NS) * 1e-3


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
def record() -> Iterator[None]:
    """Record spans in the enclosed block, with or without a trace (in
    every thread)."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


class _Off:
    """The span of a block that records nothing: every method a no-op."""

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counters) -> None:
        pass

    def cuda_events(self, device) -> None:
        pass


_OFF = _Off()


class Span:
    """An open span; :func:`span` makes it.  ``count`` sets counters,
    ``cuda_events`` times the enclosed card work with a CUDA-event pair
    (counter ``device_ms``)."""

    __slots__ = ("name", "counters", "rec", "id", "parent", "request",
                 "start_us", "events")

    def __init__(self, name: str, counters: dict):
        self.name, self.counters = name, counters
        self.rec = self.events = None

    def __bool__(self):
        return True

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.request = stack[0].request if stack else self.id
        stack.append(self)
        self.start_us = _now_us()
        if _profiler_enabled():
            self.rec = torch.profiler.record_function(self.name)
            self.rec.__enter__()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.events[2])
        if self.rec is not None:
            self.rec.__exit__(*exc)
        end_us = _now_us()
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        else:  # closed out of order: drop it wherever it is
            stack.remove(self)
        _keep({"name": self.name, "start_us": self.start_us,
               "end_us": end_us, "id": self.id, "parent": self.parent,
               "request": self.request, "thread": threading.get_ident(),
               "counters": self.counters, "events": self.events})
        return False

    def count(self, **counters) -> None:
        self.counters.update(counters)

    def cuda_events(self, device) -> None:
        """Record a CUDA event on ``device``'s current stream now and one
        when the span ends (nothing on another device)."""
        device = torch.device(device)
        if device.type != "cuda":
            return
        stream = torch.cuda.current_stream(device)
        self.events = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True), stream)
        self.events[0].record(stream)


def _keep(entry: dict) -> None:
    global _dropped
    with _lock:
        while len(_spans) >= max(LIMIT, 1):
            _spans.popleft()
            _dropped += 1
        _spans.append(entry)


def on() -> bool:
    """Whether spans are recorded now."""
    return bool(_recording) or _profiler_enabled()


def span(name: str, **counters):
    """A named region with ``counters``, recorded while :func:`on`; off
    it returns a shared no-op span (false in a boolean test)."""
    if not (_recording or _profiler_enabled()):
        return _OFF
    return Span(name, counters)


def count(**counters) -> None:
    """Set ``counters`` on the innermost span open on this thread (none
    when off or no span is open)."""
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1].count(**counters)


def annotate(name: str):
    """Named region inside a trace: a :func:`span` without counters."""
    return span(name)


def spans(clear: bool = False) -> list:
    """The buffer's spans as dicts, in the order they ended; each
    CUDA-event pair is read into the counter ``device_ms`` first (waiting
    for its end event).  ``clear`` empties the buffer and zeroes
    :func:`dropped`."""
    global _dropped
    with _lock:
        out = list(_spans)
        if clear:
            _spans.clear()
            _dropped = 0
    for entry in out:
        events = entry.pop("events", None)
        if events is not None:
            events[1].synchronize()
            entry["counters"]["device_ms"] = events[0].elapsed_time(events[1])
    return [dict(e, counters=dict(e["counters"])) for e in out]


def dropped() -> int:
    """Spans dropped from the full buffer since it was last cleared."""
    return _dropped


def newest_trace(log_dir: str) -> Path:
    """The most recently written trace file in ``log_dir``."""
    files = sorted(Path(log_dir).glob(f"*{TRACE_SUFFIX}"),
                   key=lambda p: p.stat().st_mtime_ns)
    if not files:
        raise FileNotFoundError(f"no *{TRACE_SUFFIX} in {log_dir}")
    return files[-1]
