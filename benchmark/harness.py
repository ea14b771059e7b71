"""One run of one cell: set-up, the measured window, the traced window,
the check against the plain reference, and the metrics.

Everything a cell names is found by name under the benchmark's folder
(:class:`Registry`), so a later cell, mix, op, kind of answer, generator
or metric is a new file and no edit here.
"""

from __future__ import annotations

import ctypes
import gc
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from benchmark import schedule
from benchmark.trace import traced

ROOT = Path(__file__).resolve().parent
#: Seconds of requests the traced window runs (at least one request).
TRACE_SECONDS = 2.0


class Registry:
    """The files of a benchmark folder, by name."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self._modules: dict = {}

    def json(self, folder: str, name: str) -> dict:
        with open(self.root / folder / f"{name}.json") as f:
            return json.load(f)

    def module(self, folder: str, name: str):
        key = (folder, name)
        if key not in self._modules:
            path = self.root / folder / f"{name}.py"
            if not path.is_file():
                raise FileNotFoundError(f"no {folder[:-1]} named {name!r} "
                                        f"({path})")
            mod_name = f"benchmark_{folder}_{name}".replace(".", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The entries of the metrics a run of ``workload`` reports: the
    end-to-end ones untraced, the per-layer ones traced."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


class Clock:
    """Stamps on the host clock and, on a card, CUDA events on the
    current stream, read back as seconds after :meth:`start`."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.origin = None

    def stamp(self):
        event = None
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        return (time.perf_counter(), event)

    def start(self):
        self.origin = self.stamp()
        return self.origin

    def device_s(self, stamp) -> float:
        """Seconds from the origin to ``stamp`` on the device's clock
        (the host's, without a card)."""
        if self.cuda:
            return self.origin[1].elapsed_time(stamp[1]) * 1e-3
        return stamp[0] - self.origin[0]


class Record:
    """One request of the window: its timings and what the program said
    (never its answer, which only the sample keeps)."""

    def __init__(self, req, work: int, nodes: int, edges: int):
        self.op = req.op_name
        self.kind = req.op.KIND
        self.work, self.nodes, self.edges = work, nodes, edges
        self.marks: dict = {}
        self.error: Optional[str] = None
        self.micros = self.iterations = None
        self.extra: dict = {}
        # filled in after the window, from the stamps
        self.latency_s = 0.0
        self.device: dict = {}

    def mark(self, name: str, clock: Clock) -> None:
        self.marks[name] = clock.stamp()


class Cell:
    """A cell's configuration, traffic, data and the program's graphs."""

    def __init__(self, bench: dict, workload: str, seed: int,
                 device: torch.device, registry: Registry):
        spec = next((w for w in bench["workloads"] if w["name"] == workload),
                    None)
        if spec is None:
            raise KeyError(f"no workload named {workload!r}")
        self.spec, self.seed, self.device, self.reg = spec, seed, device, registry
        self.config = registry.json("configs", spec["config"])
        self.traffic = registry.json("traffic", spec["traffic"])
        self.ops = {e["op"]: registry.module("ops", e["op"])
                    for e in self.traffic["rotation"]}
        self.generator = registry.module("generators",
                                         self.config["generator"])
        self.data = None
        self.sources: list = []
        self._graphs: dict = {}
        self._memo: dict = {}

    def graph(self, builder: Callable):
        """The graph ``builder`` makes, built once."""
        if builder not in self._graphs:
            self._graphs[builder] = builder(self)
        return self._graphs[builder]

    def memo(self, fn: Callable):
        """``fn(cell)``, computed once."""
        if fn not in self._memo:
            self._memo[fn] = fn(self)
        return self._memo[fn]

    def free_program(self) -> None:
        self._graphs.clear()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


class Run:
    """What the metric readers read: the window's records, its length,
    set-up, the traced window (or None) and the cell."""

    def __init__(self, cell: Cell, records: list, window_s: float,
                 setup_s: float, trace=None):
        self.cell, self.records, self.window_s = cell, records, window_s
        self.setup_s, self.trace = setup_s, trace

    def of(self, *ops: str) -> list:
        """The completed records of the named ops (all ops without names)."""
        return [r for r in self.records
                if r.error is None and (not ops or r.op in ops)]


def steady_host_memory() -> None:
    """Keep freed host memory in the process for reuse (glibc's
    ``mallopt``): buffers of up to 32 MiB come from the heap, which is
    never trimmed.  By default glibc moves its thresholds as blocks are
    freed, so a process either reuses the pages of the answer it just
    dropped or faults in fresh ones for every answer (a 16.8 MB copy to
    the host then takes 7-10 ms instead of 1.2-1.5), depending on what
    else happens to lie on its heap.  Fixed thresholds make every run
    the same.  Larger buffers are mapped and unmapped as before."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:  # not glibc: nothing to fix
        return
    m_trim_threshold, m_mmap_threshold = -1, -3
    libc.mallopt(m_mmap_threshold, 32 << 20)
    libc.mallopt(m_trim_threshold, 1 << 30)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _say(log, *parts) -> None:
    print(*parts, file=log, flush=True)


def _one(cell: Cell, req, clock: Clock, log):
    """Run ``req``; returns its record and answer (None if it raised)."""
    op = req.op
    nodes = op.nodes(cell)
    rec = Record(req, nodes + cell.data.m, nodes, cell.data.m)
    rec.marks["start"] = clock.stamp()
    answer = None
    try:
        answer = op.call(cell, req, lambda name: rec.mark(name, clock))
    except Exception as exc:  # a failed request is counted, not fatal
        rec.error = f"{type(exc).__name__}: {exc}"
        _say(log, f"request {req.index} ({req.op_name}) failed: {rec.error}")
    rec.marks["end"] = clock.stamp()
    if answer is not None:
        rec.micros, rec.iterations = answer.micros, answer.iterations
        rec.extra = answer.extra
    return rec, answer


def _loop(cell: Cell, stream, clock: Clock, seconds: float, log,
          sample: Optional[schedule.Sample] = None) -> tuple:
    """Requests back to back until ``seconds`` have passed; the window
    closes when the request running at that moment answers."""
    records = []
    t0 = time.perf_counter()
    while True:
        req = next(stream)
        rec, answer = _one(cell, req, clock, log)
        records.append(rec)
        if sample is not None and answer is not None:
            sample.offer(rec.kind, rec.marks["end"][0] - rec.marks["start"][0],
                         req, answer.value)
        if rec.marks["end"][0] - t0 >= seconds:
            return records, rec.marks["end"][0] - t0


def _settle(records: list, clock: Clock) -> None:
    """Turn each record's stamps into seconds."""
    for rec in records:
        rec.latency_s = rec.marks["end"][0] - rec.marks["start"][0]
        rec.device = {k: clock.device_s(v) for k, v in rec.marks.items()}


def check(cell: Cell, items: list, control: bool = False) -> dict:
    """Each sampled answer against the reference's answer to the same
    request: the worst of each number over the sample, by kind.

    Each op's kind of answer (``kinds/<KIND>.py``) gives the comparison
    and the reference's precision.  With ``control`` the program's answers
    are replaced by the reference computed one precision lower (the
    kind's ``CONTROL``)."""
    worst: dict = {}
    cache: dict = {}
    for req, value in items:
        op = req.op
        kind = cell.reg.module("kinds", op.KIND)
        key = op.ref_key(req)
        if key not in cache:
            cache[key] = op.reference(cell, req, kind.REFERENCE).cpu().numpy()
        if control:
            low = op.reference(cell, req, kind.CONTROL)
            value = low.to(torch.float32 if low.is_floating_point()
                           else torch.int64).cpu().numpy()
        for name, v in kind.compare(value, cache[key]).items():
            full = f"{op.KIND}.{name}"
            worst[full] = max(worst.get(full, float("-inf")), v)
    return worst


def judge(cell: Cell, numbers: dict) -> dict:
    """The compared numbers, each with its limit from the configuration."""
    limits = cell.config["limits"]
    out = {}
    for full, value in numbers.items():
        kind, name = full.split(".", 1)
        limit = limits.get(kind, {}).get(name)
        if limit is not None:
            # an infinite or undefined reading is printed as the largest
            # float JSON holds
            shown = value if math.isfinite(value) else sys.float_info.max
            out[full] = {"value": shown, "limit": limit}
    return out


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, *, device, registry: Optional[Registry] = None,
             started: Optional[float] = None, phases: Optional[dict] = None,
             control: bool = False, log=sys.stderr) -> dict:
    """One run of ``workload``; returns the result line's object.

    ``started`` is the process's start on ``time.perf_counter``'s clock,
    ``phases`` the set-up already spent (imports).  With ``control`` the
    result also holds ``control_numbers``: the control's readings of the
    same sample."""
    started = time.perf_counter() if started is None else started
    steady_host_memory()
    phases = dict(phases or {})
    device = torch.device(device)
    reg = registry or Registry()
    cell = Cell(bench, workload, seed, device, reg)
    rng = random.Random(seed)

    def phase(name, fn):
        t = time.perf_counter()
        out = fn()
        _sync(device)
        phases[name] = time.perf_counter() - t
        return out

    if device.type == "cuda":
        from graph_tpu_torch.engine import _build
        phase("kernels", lambda: _build.build(
            ("k1_gather", "k2_reduce", "loop_seq_new")))
        torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 64))
    cell.data = phase("generate", lambda: cell.generator.make(cell.config,
                                                              gen))
    if "sources" in cell.traffic:
        cell.sources = cell.generator.sources(cell.data,
                                              int(cell.traffic["sources"]), gen)

    def build():
        for op in cell.ops.values():
            cell.graph(op.GRAPH)
            op.nodes(cell)
    phase("build", build)
    clock = Clock(device)
    clock.start()
    warm = schedule.requests(cell.traffic, cell.ops, cell.sources,
                             random.Random(rng.random()))
    stream = schedule.requests(cell.traffic, cell.ops, cell.sources,
                               random.Random(rng.random()))
    sample = schedule.Sample(int(cell.traffic.get("sample", 2)),
                             random.Random(rng.random()))
    rounds = int(cell.traffic.get("warmup", 1)) * sum(
        int(e.get("weight", 1)) for e in cell.traffic["rotation"])

    def warmup():
        for _ in range(rounds):
            rec, answer = _one(cell, next(warm), clock, log)
            if rec.error:
                raise RuntimeError(f"warm-up request failed: {rec.error}")
            sample.reserve(rec.kind, answer.value)
    phase("warmup", warmup)
    for name, s in phases.items():
        _say(log, f"setup {name} {s:.6f} s")

    gc.collect()
    t_window = time.perf_counter()
    setup_s = t_window - started
    clock.start()
    records, window_s = _loop(cell, stream, clock, seconds, log, sample)
    _sync(device)
    _settle(records, clock)
    tr = None
    if trace:
        with traced() as box:
            traced_records, _ = _loop(cell, stream, clock, TRACE_SECONDS, log)
            _sync(device)
        tr = box[0]
        del traced_records
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)

    cell.free_program()
    items = sample.items()
    numbers = check(cell, items)
    checks = judge(cell, numbers)
    failed = sum(r.error is not None for r in records)
    kinds = {op.KIND for op in cell.ops.values()}
    correct = (failed == 0 and bool(checks)
               and kinds <= {k.split(".")[0] for k in checks}
               and all(numbers[k] <= c["limit"] for k, c in checks.items()))
    run = Run(cell, records, window_s, setup_s, tr)
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        value = reg.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": len(records),
              "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = tr.breakdown()
    if control:
        result["numbers"] = numbers
        result["control_numbers"] = check(cell, items, control=True)
    result["checks"] = checks
    return result
