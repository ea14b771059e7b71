"""Device-resident iteration loops: the port's ``jax.lax.while_loop``.

Every iterative driver of ``graph_tpu`` is one jitted program whose loop
runs on the device inside ``jax.lax.while_loop``: the condition stays on
the device and the host reads the result once.  :func:`device_while` is
its counterpart.  On CUDA tensors it captures the loop body once into CUDA
graphs (``torch.cuda.CUDAGraph``) and runs them under a conditional WHILE
node assembled by ``csrc/device_loop.cu``: a one-thread kernel at the end
of each body evaluates the condition on the card and sets the node's
handle.  The host launches the graph and then reads, in one transfer, the
iteration counts and the condition's value.

:func:`host_while` is its plain version, the Python loop that reads the
condition back before each body.  :func:`device_while` runs it for CPU
tensors, as every kernel wrapper runs its plain version there; on the
card it never falls back to it: a capture, an instantiation or a launch
that fails raises.

A loop's ``state`` is a tuple of tensors and Python scalars (the scalars
stand for ``graph_tpu``'s constants in the loop's initial state), and
its ``body`` maps the state to a new state of tensors.  The body is a
callable, or a tuple of steps run in order, each a callable or a nested
:class:`While`: ``graph_tpu``'s delta-stepping nests two
``while_loop``s.  The condition is a :class:`Flag` or a
:class:`Residual` over one scalar of the state.

On the card the body is captured once: it must launch no host read
(``.item()``, ``bool()``, ``nonzero``), or capture raises.  A body that
is one callable over a large state (:func:`two_buffers`) runs on two
sets of state buffers, captured twice: the first reads the first set and
writes the second, the second the reverse, so that no round copies its
result back.  It is called ``body(state, out)`` there, ``out`` holding
for each state entry the buffer its new value goes to: an op may write
into it (``out=``, see :func:`into`) and return it; any other result is
copied into it.  On the host, and as a step of a nested body, it is
called ``body(state)``.  A nested body's pieces, and a small state's
body, copy their outputs into one set of buffers.  An output that is its
own input (a loop-invariant) is never copied.  Given a ``cache`` (a
dict, held by the engine or the graph the loop runs on, as ``graph_tpu``
holds ``eng._pr_runs``), the captured loop is kept under ``key`` and a
later call only copies its new state into the captured buffers: the body
and the condition's kind must then be the same, and the closure of the
first call (whose tensors the graph reads) is the one that runs.  A
cached loop serves one run at a time: threads that share it take turns,
from copying their state in to cloning the result out.

The kernel wrappers count their launches in Python, which on the card
happens once, at capture.  :func:`device_while` takes those counts as the
per-body launches, holds them against the kernel nodes of each captured
graph (``kernels.KERNEL_NODES``), and, after each run, adds to
``graph_tpu_torch.engine.kernels.LAUNCHES`` the per-body counts times the
bodies the device reports; capture itself counts nothing.

While :func:`graph_tpu_torch.profile.on`, a run is a ``loop.run`` span
with counters ``bodies`` (each loop's count, outer first), ``launches``
(the kernel launches it added), ``host_reads`` and, on the card,
``device_ms`` (the graph's CUDA-event time, read after the run's one
host read) and ``cached``; a capture is a ``loop.capture`` and a
``loop.instantiate`` span.
"""

from __future__ import annotations

import ctypes
import dataclasses
import re
import threading
import time
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from graph_tpu_torch import profile
from graph_tpu_torch.engine import _build, kernels

Body = Union[Callable, Sequence]

#: Launches of a device loop's graph since the last :func:`reset_launches`
#: (one a run, wherever :meth:`DeviceLoop.run` launches it).
LAUNCHES = {"device_loop": 0}


def reset_launches() -> None:
    LAUNCHES["device_loop"] = 0


@dataclasses.dataclass(frozen=True)
class Flag:
    """Loop while the int32 flag ``state[index]`` is nonzero: WCC's and
    SSSP's ``changed``."""

    index: int

    kind = 0
    dtype = torch.int32

    #: the host loop reads the flag before each test
    reads = True

    def test(self, value, it: int) -> bool:
        return value != 0


@dataclasses.dataclass(frozen=True)
class Residual:
    """Loop while ``it < max_iterations and state[index] >= tolerance``:
    PageRank's condition, ``it`` the bodies run so far and the f32
    ``state[index]`` the residual.  ``tolerance`` is rounded to f32, as
    the device compares it."""

    index: int
    max_iterations: int
    tolerance: float

    kind = 1
    dtype = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "max_iterations", int(self.max_iterations))
        object.__setattr__(self, "tolerance",
                           float(np.float32(self.tolerance)))

    @property
    def reads(self) -> bool:
        """Whether the host loop reads the residual before each test: only
        when it can stop the loop (a tolerance <= 0 never stops it on a
        residual that is a number)."""
        return self.tolerance > 0

    def test(self, value, it: int) -> bool:
        if it >= self.max_iterations:
            return False
        return value is None or value >= self.tolerance


Cond = Union[Flag, Residual]

#: The bytes of a state's largest tensor from which a one-step body runs
#: on two sets of buffers.  Their rounds of two bodies need an IF node,
#: which costs more than copying a small vector back.  On an H100 (700 W,
#: chip_smoke's ``device_loop`` phase, which times both ways) two buffers
#: took 1.1-1.3 µs a round more than the copy at 4 MB (SSSP on the 1024
#: grid), and at 16 MB 3.6-4.9 and 9.6-10.0 µs a round less (PageRank and
#: SSSP at RMAT 22) but 3.6-4.8 µs more (WCC).
PAIR_MIN_BYTES = 1 << 23


@dataclasses.dataclass(frozen=True)
class While:
    """A loop nested in a body: ``body`` and ``cond`` as for
    :func:`device_while`, over the enclosing loop's whole state."""

    body: Body
    cond: Cond


@dataclasses.dataclass(frozen=True)
class Loop:
    """What a loop returns: the final ``state``, the bodies the loop ran
    (``iterations``), its condition's scalar as the host read it
    (``value``), the values the host read back during the run
    (``host_reads``), and the bodies each nested loop ran in all
    (``inner``, in the order the loops appear)."""

    state: tuple
    iterations: int
    value: Union[int, float]
    host_reads: int
    inner: Tuple[int, ...] = ()


def _steps(body: Body) -> tuple:
    return tuple(body) if isinstance(body, (tuple, list)) else (body,)


def _loops(body: Body, cond: Cond) -> list:
    """Every loop of a body as (body, cond), outer first, then each nested
    loop in the order it appears (depth first)."""
    out = [(body, cond)]
    for step in _steps(body):
        if isinstance(step, While):
            out += _loops(step.body, step.cond)
    return out


def _apply(step, state: tuple, out: Optional[tuple] = None) -> tuple:
    res = tuple(step(state) if out is None else step(state, out))
    if len(res) != len(state):
        raise ValueError(f"a loop body returned {len(res)} values for a "
                         f"state of {len(state)}")
    return res


def into(out: Optional[tuple], index: int) -> Optional[torch.Tensor]:
    """The buffer a body may write ``state[index]``'s new value into
    (``out=``): ``out[index]``, or None when the body was given no
    buffers."""
    return None if out is None else out[index]


def host_while(body: Body, state: Sequence, cond: Cond) -> Loop:
    """The plain version of :func:`device_while`: a Python loop that reads
    the condition's scalar back before each body (a Python scalar is known
    without a read; a :class:`Residual` with a tolerance <= 0 reads its
    residual once, at the end)."""
    index = {id(b): i for i, (b, _) in enumerate(_loops(body, cond))}
    counts = [0] * len(index)
    reads = 0

    def run(body, state, cond):
        nonlocal reads
        it, value = 0, None
        while True:
            v = state[cond.index]
            if not isinstance(v, torch.Tensor):
                value = v
            elif cond.reads:
                value = v.item()  # host read: the condition decides the loop
                reads += 1
            else:
                value = None
            if not cond.test(value, it):
                break
            for step in _steps(body):
                if isinstance(step, While):
                    state = run(step.body, state, step.cond)[0]
                else:
                    state = _apply(step, state)
            it += 1
        counts[index[id(body)]] += it
        return state, it, value

    with profile.span("loop.run") as sp:
        before = dict(kernels.LAUNCHES) if sp else None
        state, it, value = run(body, tuple(state), cond)
        if value is None:  # the residual was never read: read it once
            value = state[cond.index].item()
            reads += 1
        if sp:
            sp.count(bodies=[it] + counts[1:], host_reads=reads, launches={
                k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()
                if v != before.get(k, 0)})
    return Loop(state=state, iterations=it, value=value, host_reads=reads,
                inner=tuple(counts[1:]))


def two_buffers(body: Body, state: Sequence) -> bool:
    """Whether a device loop runs ``body`` on two sets of buffers: a body
    of one callable (no nested loop) over a state whose largest tensor
    holds at least :data:`PAIR_MIN_BYTES`."""
    largest = max((v.numel() * v.element_size() for v in state
                   if isinstance(v, torch.Tensor)), default=0)
    return callable(body) and largest >= PAIR_MIN_BYTES


def device_while(body: Body, state: Sequence, cond: Cond, *,
                 cache: Optional[dict] = None, key=None) -> Loop:
    """``jax.lax.while_loop(cond, body, state)`` on the state's device.

    CPU tensors run :func:`host_while`.  CUDA tensors run the loop as one
    conditional CUDA graph, captured at the first call (or taken from
    ``cache[key]``), with one host read after the loop: ``host_reads`` is
    1.  The returned state holds new tensors; a loop-invariant entry is
    the caller's own.
    """
    state = tuple(state)
    device = next((v.device for v in state if isinstance(v, torch.Tensor)),
                  None)
    if device is None:
        raise ValueError("a loop's state needs at least one tensor")
    if device.type == "cpu":
        return host_while(body, state, cond)
    with _LOCK:  # one capture at a time; a loop cached once
        loop = None if cache is None else cache.get(key)
        cached = loop is not None
        if not cached:
            loop = DeviceLoop(body, state, cond, device)
            if cache is not None:
                cache[key] = loop
    return loop.run(state, body, cond, cached=cached)


def _lib(name: str):
    return _build.load(name)


def _call(name: str, *args) -> None:
    err = _lib(name)(*args)
    if err != 0:
        raise RuntimeError(f"device loop: {name} failed with CUDA error "
                           f"{err}")


def kernel_nodes(graph: "torch.cuda.CUDAGraph") -> list:
    """The mangled names of the device functions of a captured graph's
    kernel nodes (its child graphs' too), one a node."""
    cap = 1 << 20
    buf = ctypes.create_string_buffer(cap)
    used = ctypes.c_longlong(0)
    _call("loop_graph_kernels", graph.raw_cuda_graph(), buf, cap,
          ctypes.byref(used))
    return buf.raw[:used.value].decode().splitlines()


class DeviceLoop:
    """A loop captured once into CUDA graphs and instantiated as one graph
    with a conditional WHILE node per loop (:func:`device_while`).

    Holds the state buffers the graph reads and writes (two sets where
    :func:`two_buffers`), the torch graphs of the captured pieces
    (whose memory pool holds the bodies' intermediates), the bodies'
    closures, each loop's counter and limits in device memory, and each
    piece's launches per body.  :meth:`run` holds a lock: one run at a
    time.
    """

    def __init__(self, body: Body, state: tuple, cond: Cond,
                 device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"a device loop runs on a CUDA device, got "
                             f"{device}")
        if not torch.cuda.is_available():
            raise RuntimeError("a device loop needs a CUDA device; none is "
                               "available")
        self.device = device
        self.body, self.cond = body, cond
        #: a body of one callable, the kind :func:`two_buffers` may pair
        self.one_step = callable(body)
        loops = _loops(body, cond)
        if any(isinstance(c, Residual) for _, c in loops[1:]):
            # a nested loop's counter runs on across the outer rounds
            raise ValueError("a nested loop's condition must be a Flag")
        cond_dtype = {}
        for _, c in loops:
            if cond_dtype.setdefault(c.index, c.dtype) != c.dtype:
                raise ValueError(f"state[{c.index}] is the scalar of two "
                                 "kinds of condition")
        self.buffers = tuple(self._buffer(v, cond_dtype.get(i))
                             for i, v in enumerate(state))
        #: the second set of buffers (:func:`two_buffers`)
        self.other: Optional[tuple] = None
        self.counters = torch.zeros(len(loops), dtype=torch.int32,
                                    device=device)
        self.max_iterations = torch.zeros(len(loops), dtype=torch.int32,
                                          device=device)
        self.tolerance = torch.zeros(len(loops), dtype=torch.float32,
                                     device=device)
        self._limits = None    # the limits last copied to the card
        self.go = torch.zeros(1, dtype=torch.int32, device=device)
        self.graphs = []       # the captured pieces' torch graphs
        #: (loop index, its bodies -> this piece's runs, launches a run)
        self.per_body = []
        self.invariant = [True] * len(state)
        self.lock = threading.Lock()
        self.pool = None
        self._seqs = []
        self._exec = None
        self.capture_s = self.instantiate_s = 0.0
        #: CUDA events around the last launch (:meth:`graph_ms`)
        self._events = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
        with profile.span("loop.capture"):
            t0 = time.perf_counter()
            _destroy_retired()
            torch.cuda.synchronize(device)
            with torch.cuda.device(device):
                top = ctypes.c_void_p()
                _call("loop_seq_new", ctypes.byref(top))
                self._seqs.append(top)
                if two_buffers(body, state):
                    self._assemble_pair(top, body, cond)
                else:
                    self._assemble(top, body, cond, iter(range(len(loops))))
                torch.cuda.synchronize(device)
            self.capture_s = time.perf_counter() - t0
        with profile.span("loop.instantiate"):
            t0 = time.perf_counter()
            exec_ = ctypes.c_void_p()
            with torch.cuda.device(device):
                _call("loop_seq_instantiate", top, ctypes.byref(exec_))
            self._exec = exec_
            self.instantiate_s = time.perf_counter() - t0

    def _buffer(self, v, dtype) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            if v.device != self.device:
                raise ValueError(f"a loop's state lies on {v.device} and "
                                 f"{self.device}")
            return torch.empty_like(v, dtype=dtype or v.dtype,
                                    memory_format=torch.contiguous_format)
        if dtype is None:
            dtype = torch.float32 if isinstance(v, float) else torch.int32
        return torch.empty((), dtype=dtype, device=self.device)

    def _scalar(self, buffers: tuple, cond: Cond) -> torch.Tensor:
        value = buffers[cond.index]
        if value.numel() != 1:
            raise ValueError(f"state[{cond.index}], a condition's scalar, "
                             f"has {value.numel()} elements")
        return value

    def _while(self, seq, cond: Cond, i: int) -> ctypes.c_void_p:
        """Append loop ``i``'s WHILE node to ``seq``; returns its body."""
        inner = ctypes.c_void_p()
        _call("loop_seq_while", seq, cond.kind,
              self.counters[i:].data_ptr(),
              self._scalar(self.buffers, cond).data_ptr(),
              self.max_iterations[i:].data_ptr(),
              self.tolerance[i:].data_ptr(), ctypes.byref(inner))
        self._seqs.append(inner)
        return inner

    def _assemble_pair(self, seq, body, cond) -> None:
        """Append the loop of a body that is one callable: a WHILE node
        whose round runs the body from the first set of buffers into the
        second and, under an IF node on the condition, back."""
        inner = self._while(seq, cond, 0)
        first = self.buffers
        out = tuple(torch.empty_like(b) for b in first)
        _call("loop_seq_child", inner,
              self._capture(body, first, out, 0, lambda c: (c + 1) // 2)
              .raw_cuda_graph())
        second = self.other = tuple(
            b if inv else o for b, o, inv in zip(first, out, self.invariant))
        branch = ctypes.c_void_p()
        _call("loop_seq_if", inner,
              self._scalar(second, cond).data_ptr(), self.go.data_ptr(),
              ctypes.byref(branch))
        self._seqs.append(branch)
        back = tuple(None if inv else b
                     for b, inv in zip(first, self.invariant))
        _call("loop_seq_child", branch,
              self._capture(body, second, back, 0, lambda c: c // 2)
              .raw_cuda_graph())
        _call("loop_seq_close", branch)
        _call("loop_seq_close", inner)

    def _assemble(self, seq, body, cond, numbers) -> None:
        """Append to ``seq`` the loop (body, cond) as a WHILE node whose
        body runs the captured pieces and nested loops, each piece copying
        its outputs into the one set of buffers."""
        i = next(numbers)
        inner = self._while(seq, cond, i)
        for step in _steps(body):
            if isinstance(step, While):
                self._assemble(inner, step.body, step.cond, numbers)
            else:
                graph = self._capture(step, self.buffers, None, i,
                                      lambda c: c)
                _call("loop_seq_child", inner, graph.raw_cuda_graph())
        _call("loop_seq_close", inner)

    def _capture(self, step, state: tuple, out: Optional[tuple], i: int,
                 runs) -> "torch.cuda.CUDAGraph":
        """One piece of a body, captured on a stream of its own with its
        outputs' stores into ``out`` (``state`` itself when None).  Its
        kernel launches are recorded, not counted, and held against the
        graph's kernel nodes; ``runs`` maps loop ``i``'s bodies to the
        piece's.  A capture that fails (a host read in the body) raises,
        with the caller's stream current again."""
        before = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    self._store(_apply(step, state, out), state, out)
                except BaseException:
                    try:
                        graph.capture_end()
                    except Exception:  # the capture's own error follows
                        pass
                    raise
                graph.capture_end()
        finally:
            launched = {k: kernels.LAUNCHES[k] - before.get(k, 0)
                        for k in kernels.LAUNCHES}
            kernels.LAUNCHES.update(before)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self.pool = graph.pool()
        self.graphs.append(graph)
        names = kernel_nodes(graph)
        for name, pattern in kernels.KERNEL_NODES.items():
            nodes = sum(bool(re.search(pattern, n)) for n in names)
            if nodes != launched.get(name, 0):
                raise RuntimeError(
                    f"device loop: a captured body holds {nodes} {name} "
                    f"kernel nodes where its wrapper launched "
                    f"{launched.get(name, 0)}")
        self.per_body.append((i, runs, launched))
        return graph

    def _store(self, res: tuple, state: tuple, out: Optional[tuple]) -> None:
        """Copy a piece's outputs that are not already in place into
        ``out`` (``state`` when None) (captured)."""
        dst = state if out is None else out
        for j, (old, buf, new) in enumerate(zip(state, dst, res)):
            if new is old:
                continue
            if not isinstance(new, torch.Tensor):
                raise TypeError(f"a loop body returned "
                                f"{type(new).__name__} for state[{j}]; "
                                "tensors only")
            if buf is None:
                raise ValueError(f"state[{j}] is changed by one capture of "
                                 "a loop body and kept by the other")
            self.invariant[j] = False
            if new is not buf:
                buf.copy_(new)

    def run(self, state: tuple, body: Body, cond: Cond, *,
            cached: bool = True) -> Loop:
        """Copy ``state`` into the buffers, set each loop's limits from
        ``cond`` and the :class:`While` steps of ``body``, launch, queue
        the result's clones, and read the counts and the condition's
        scalar once; one run at a time.  ``cached``: whether the loop came
        from a cache (the ``loop.run`` span's counter)."""
        if len(state) != len(self.buffers):
            raise ValueError(f"a state of {len(state)} for a loop captured "
                             f"with {len(self.buffers)}")
        conds = [c for _, c in _loops(body, cond)]
        if [type(c) for c in conds] != [type(c) for _, c in
                                        _loops(self.body, self.cond)]:
            raise ValueError("a cached device loop run with other loops")
        limits = [(c.max_iterations, c.tolerance)
                  if isinstance(c, Residual) else (0, 0.0) for c in conds]
        with self.lock:
            _destroy_retired()
            with profile.span("loop.run") as sp:
                with torch.cuda.device(self.device):
                    out, got = self._launch(state, cond, limits)
                counts = [int(c) for c in got[:-1]]
                launched: dict = {}
                for i, runs, per_run in self.per_body:
                    for name, k in per_run.items():
                        launched[name] = (launched.get(name, 0)
                                          + k * runs(counts[i]))
                if sp:  # the read above has waited for the graph
                    sp.count(device_ms=self.graph_ms(), cached=cached,
                             bodies=counts, host_reads=1, launches={
                                 k: v for k, v in launched.items() if v})
        for name, k in launched.items():
            kernels.LAUNCHES[name] += k
        value = got[-1]
        if isinstance(cond, Flag):
            value = int(value)
        return Loop(state=out, iterations=counts[0], value=value,
                    host_reads=1, inner=tuple(counts[1:]))

    def _launch(self, state: tuple, cond: Cond, limits: list):
        for buf, v in zip(self.buffers, state):
            if v is buf:
                continue
            if isinstance(v, torch.Tensor):
                buf.copy_(v)
            else:
                buf.fill_(v)
        if limits != self._limits:  # a host-to-card copy only when new
            self.max_iterations.copy_(torch.tensor(
                [m for m, _ in limits], dtype=torch.int32))
            self.tolerance.copy_(torch.tensor(
                [t for _, t in limits], dtype=torch.float32))
            self._limits = limits
        self.counters.zero_()
        stream = torch.cuda.current_stream(self.device)
        self._events[0].record(stream)
        _call("loop_exec_launch", self._exec, stream.cuda_stream)
        LAUNCHES["device_loop"] += 1
        self._events[1].record(stream)
        if self.other is None:
            pick = lambda j: self.buffers[j].clone()  # noqa: E731
        else:  # an odd count of bodies ends in the second set
            odd = (self.counters[0] & 1).bool()
            pick = lambda j: torch.where(  # noqa: E731
                odd, self.other[j], self.buffers[j])
        out = tuple(v if self.invariant[j] else pick(j)
                    for j, v in enumerate(state))
        value = out[cond.index] if not self.invariant[cond.index] \
            else self.buffers[cond.index]
        # the one host read, queued after the clones: every loop's count
        # and the condition
        return out, torch.cat([self.counters.double(),
                               value.reshape(1).double()]).tolist()

    def graph_ms(self) -> float:
        """The card's milliseconds from the start of the last run's graph
        to its end (CUDA events; the run has read its result, so no
        further wait)."""
        return self._events[0].elapsed_time(self._events[1])

    def __del__(self):
        # a loop may be collected while a piece is being captured, when
        # destroying a graph would break that capture: its graphs are then
        # destroyed at the next capture or run
        _RETIRED.append((getattr(self, "_exec", None),
                         getattr(self, "_seqs", []),
                         getattr(self, "graphs", [])))
        try:
            _destroy_retired()
        except Exception:  # interpreter shutdown: CUDA is torn down
            pass


#: Held while a loop is looked up in its cache and captured, and while
#: collected loops are destroyed.
_LOCK = threading.RLock()
#: Loops collected and not yet destroyed: (exec, sequences, torch graphs).
_RETIRED: list = []


def _destroy_retired() -> None:
    """Destroy the graphs of collected loops, unless a capture is under
    way (in this thread or another)."""
    if not _LOCK.acquire(blocking=False):
        return
    try:
        if torch.cuda.is_current_stream_capturing():
            return
        while _RETIRED:
            exec_, seqs, _ = _RETIRED.pop()
            if exec_ is not None:
                _lib("loop_exec_free")(exec_)
            for seq in reversed(seqs):
                _lib("loop_seq_free")(seq)
    finally:
        _LOCK.release()
