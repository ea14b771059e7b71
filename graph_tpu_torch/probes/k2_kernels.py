"""The K2 stream-floor probes' kernels, with their plain versions.

Counterparts of the eight Pallas sites of ``scripts/perf_k2_{io,io2,io3,
io4,io5,streams}.py``, written by hand in CUDA C++ for Hopper
(``graph_tpu_torch/csrc/k2_probes.cu``).  A variant is a list of steps
(:class:`graph_tpu_torch.probes.k2_layout.Steps`) over a contribution
stream ``v`` (rows, 128) f32 and up to five side streams (rows, 128) u16
or int32 (a touched side may be (rows, 640)).  In grid order, ``passes``
times, step k sets out block ``ob[k]`` to 0 when ``zero[k]`` and adds:

* :func:`sec_stream` (int32 out, sums wrap): ``T(v[rows]) + sides``, with
  ``T`` ``"trunc"`` (toward zero), ``"round"`` (``round(v * 2^30)``, half
  to even) or ``"bitcast"`` (the f32 bits), and each side read ``"full"``
  (its rows, widened) or by ``"touch"`` (its element ``[row0[k], 0]``);
* :func:`sec_stream_f32` (f32 out): ``acc = ((v[rows] + f(t0)) + f(t1))
  ...`` for each touched side ``t``, ``f(t) = float32(int32(t))``, every
  add rounded in f32 (``perf_k2_streams.py``).

A block that no step zeroes starts from ``init``, and a block no step
touches is ``init``: the TPU leaves both undefined (interpret mode fills a
fresh int32 output with INT32_MIN and an f32 one with NaN).  Inputs are in
range: ``T`` of every value fits int32.

Each wrapper takes a :class:`Schedule` (:func:`schedule`: the steps
grouped by out block and cut into pieces on the host) and runs its plain
version for tensors on the CPU.  For CUDA tensors it checks device, dtype,
shape, alignment and contiguity, launches its kernel on the current
stream (building it at first use) and raises if the launch reports an
error; it never falls back to the plain version on the card.
``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Sequence

import numpy as np
import torch

from graph_tpu_torch.engine import _build
from graph_tpu_torch.probes.k2_layout import LANES, Steps
from graph_tpu_torch.probes.kernels import _check, _on_cpu

MODES = ("trunc", "round", "bitcast")
READS = ("touch", "full")
MAX_SIDES = 5
#: Steps a piece of a block's chain (csrc/k2_probes.cu).
PIECE_STEPS = 32
#: Piece kinds, and the flags beside them in a piece's last word.
DEAD, STORE, ADD = 0, 1, 2
ZEROED, FIRST = 1 << 4, 1 << 5

#: Kernel launches since the last :func:`reset_launches`.  A wrapper adds
#: one where it launches its kernel, and nowhere else.
LAUNCHES = {"probe_sec_stream": 0, "probe_sec_stream_f32": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---- plain versions --------------------------------------------------------

def _rows(steps: Steps, device) -> torch.Tensor:
    """(S, h) row indices of every step."""
    row0 = torch.from_numpy(steps.row0).to(device)
    return row0[:, None] + torch.arange(steps.h, device=device)


def _touched(side: torch.Tensor, steps: Steps) -> torch.Tensor:
    """(S, 1, 1) int32: each step's ``side[row0, 0]``."""
    col = side[:, 0].to(torch.int32)
    return col[torch.from_numpy(steps.row0).to(side.device)][:, None, None]


def _quantize(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "trunc":
        return x.to(torch.int32)
    if mode == "round":
        return torch.round(x * float(1 << 30)).to(torch.int32)
    return x.view(torch.int32)


def _apply(out: torch.Tensor, q: torch.Tensor, steps: Steps) -> None:
    """The grid's sequence on ``out`` (nout, h*128): for every pass and
    step k in order, ``out[ob[k]] = (0 if zero[k] else out[ob[k]]) +
    q[k]``.  Distinct blocks' steps are independent, so round i applies
    the i-th step of every block's chain (over all passes) at once."""
    order = np.argsort(steps.ob, kind="stable")
    cnt = np.bincount(steps.ob, minlength=steps.nout)
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    blocks = np.nonzero(cnt)[0]
    length = cnt[blocks] * steps.passes
    dev = out.device
    for i in range(int(length.max()) if len(blocks) else 0):
        b = blocks[length > i]
        k = order[start[b] + i % cnt[b]]
        bt = torch.from_numpy(b).to(dev)
        kt = torch.from_numpy(k).to(dev)
        zt = torch.from_numpy(steps.zero[k]).to(dev)[:, None]
        out[bt] = torch.where(zt, torch.zeros((), dtype=out.dtype,
                                              device=dev), out[bt]) + q[kt]


def sec_stream_plain(v: torch.Tensor, sides: Sequence[torch.Tensor],
                     steps: Steps, mode: str, read: str,
                     init: int = 0) -> torch.Tensor:
    """Plain version of :func:`sec_stream`: (nout * h, 128) int32.  Sums
    are taken in int64 and wrapped to int32 at the end."""
    rows = _rows(steps, v.device)
    q = _quantize(v[rows], mode).to(torch.int64)
    for side in sides:
        if read == "full":
            q += side.to(torch.int32)[rows]
        else:
            q += _touched(side, steps)
    out = torch.full((steps.nout, steps.h * LANES), int(init),
                     dtype=torch.int64, device=v.device)
    _apply(out, q.reshape(steps.nsteps, steps.h * LANES), steps)
    wrapped = torch.remainder(out + (1 << 31), 1 << 32) - (1 << 31)
    return wrapped.to(torch.int32).view(-1, LANES)


def sec_stream_f32_plain(v: torch.Tensor, sides: Sequence[torch.Tensor],
                         steps: Steps, init: float = 0.0) -> torch.Tensor:
    """Plain version of :func:`sec_stream_f32`: (nout * h, 128) f32."""
    acc = v[_rows(steps, v.device)]
    for side in sides:
        acc = acc + _touched(side, steps).to(torch.float32)
    out = torch.full((steps.nout, steps.h * LANES), float(init),
                     dtype=torch.float32, device=v.device)
    _apply(out, acc.reshape(steps.nsteps, steps.h * LANES), steps)
    return out.view(-1, LANES)


# ---- the schedule ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Schedule:
    """A variant's steps cut for the kernels: ``pieces`` (P, 4) int64
    ``[block, chain offset, steps, kind | flags]`` and ``chain`` the row0
    of each piece's steps, both on ``device``; ``ordered`` keeps each
    block's live chain in one piece (f32)."""

    steps: Steps
    pieces: torch.Tensor
    chain: torch.Tensor
    sink: torch.Tensor
    ordered: bool

    @property
    def device(self) -> torch.device:
        return self.chain.device


def _cut(lo: int, hi: int, n: int, piece_steps: int) -> list:
    """[lo, hi) of a block's chain (n steps a pass) cut at every pass and
    into at most ``piece_steps`` steps: (start, size) pairs."""
    out = []
    a = lo
    while a < hi:
        end = min(hi, (a // n + 1) * n, a + piece_steps)
        out.append((a, end - a))
        a = end
    return out


def schedule(steps: Steps, device, ordered: bool = False,
             piece_steps: int = PIECE_STEPS) -> Schedule:
    """Group the steps by out block, in grid order, over every pass; cut
    each block's chain at its last zero into a dead part (read, its value
    overwritten) and a live part, and both at every pass and into pieces
    of at most ``piece_steps`` steps (the live part whole when
    ``ordered``).  A block with one live piece stores it; with several,
    each piece adds.  Pieces are ordered by pass, then block, so the
    card's blocks stream the rows pass after pass, as the TPU's grid
    did, rather than read one block's rows again while they are in L2."""
    p = steps.passes
    order = np.argsort(steps.ob, kind="stable")
    cnt = np.bincount(steps.ob, minlength=steps.nout)
    ends = np.cumsum(cnt)
    pieces, chain = [], []
    off = 0
    for b in np.nonzero(cnt)[0]:
        ks = order[ends[b] - cnt[b]:ends[b]]
        n = len(ks)
        z = np.nonzero(steps.zero[ks])[0]
        live0 = (p - 1) * n + int(z[-1]) if len(z) else 0
        total = p * n
        for a, size in _cut(0, live0, n, piece_steps):
            pieces.append((a // n, b, off + a, size, DEAD))
        cuts = ([(live0, total - live0)] if ordered
                else _cut(live0, total, n, piece_steps))
        kind = STORE if len(cuts) == 1 else ADD
        flags = ZEROED if len(z) else 0
        for i, (a, size) in enumerate(cuts):
            pieces.append((a // n, b, off + a, size,
                           kind | flags | (FIRST if i == 0 else 0)))
        chain.append(np.tile(steps.row0[ks], p))
        off += total
    pieces.sort()
    table = np.array([pc[1:] for pc in pieces], np.int64).reshape(-1, 4)
    rows = np.concatenate(chain) if chain else np.zeros(0, np.int64)
    dev = torch.device(device)
    return Schedule(steps, torch.from_numpy(table).to(dev),
                    torch.from_numpy(rows).to(dev),
                    torch.zeros(1, dtype=torch.int32, device=dev), ordered)


def moved_bytes(steps: Steps, sides: Sequence[torch.Tensor],
                read: str) -> int:
    """Bytes the kernel must move: every step's rows of v (and of each
    full side), one element of each touched side a step, every pass; each
    out block written once."""
    slot_rows = steps.nsteps * steps.passes * steps.h * LANES
    side_b = sum(s.element_size() for s in sides)
    sides_b = side_b * slot_rows if read == "full" else (
        side_b * steps.nsteps * steps.passes)
    return 4 * slot_rows + sides_b + 4 * steps.nout * steps.h * LANES


# ---- wrappers --------------------------------------------------------------

def _check_inputs(v: torch.Tensor, sides, sched: Schedule, read: str,
                  int_sides: tuple) -> tuple:
    """Checks for a launch; returns (is32, wide) bit masks."""
    steps = sched.steps
    dev = v.device
    if sched.device != dev:
        raise ValueError(f"schedule is on {sched.device}, v on {dev}")
    if len(sides) > MAX_SIDES:
        raise ValueError(f"at most {MAX_SIDES} sides, got {len(sides)}")
    _check("v", v, (torch.float32,), dev,
           v.dim() == 2 and v.shape[1] == LANES
           and v.shape[0] >= steps.rows_needed,
           f"(>= {steps.rows_needed}, 128)", 16)
    is32 = wide = 0
    for i, s in enumerate(sides):
        widths = (LANES,) if read == "full" else (LANES, 5 * LANES)
        need = steps.rows_needed if read == "full" else (
            steps.rows_needed - steps.h + 1)
        _check(f"side {i}", s, int_sides, dev,
               s.dim() == 2 and s.shape[1] in widths and s.shape[0] >= need,
               f"(>= {need}, {' or '.join(map(str, widths))})",
               4 * s.element_size() if read == "full" else s.element_size())
        is32 |= (s.dtype == torch.int32) << i
        wide |= (s.shape[1] != LANES) << i
    return is32, wide


def _launch(name: str, v, sides, sched: Schedule, out: torch.Tensor,
            *options) -> None:
    if not sched.pieces.shape[0]:
        return
    ptrs = [s.data_ptr() for s in sides] + [None] * (MAX_SIDES - len(sides))
    fn = _build.load(name)
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), *ptrs, out.data_ptr(),
                 sched.pieces.data_ptr(), sched.chain.data_ptr(),
                 sched.sink.data_ptr(), sched.pieces.shape[0],
                 sched.steps.h, len(sides), *options,
                 torch.cuda.current_stream(v.device).cuda_stream)
    LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def sec_stream(v: torch.Tensor, sides: Sequence[torch.Tensor],
               sched: Schedule, mode: str, read: str,
               init: int = 0) -> torch.Tensor:
    """The int32 section stream: (nout * h, 128) int32 (module doc).

    v: (rows, 128) f32; sides: up to five (rows, 128) u16 or int32
    tensors (touched ones may be (rows, 640)); ``mode`` one of
    :data:`MODES`, ``read`` one of :data:`READS`; ``init`` the starting
    value of blocks never zeroed or never touched."""
    if mode not in MODES or read not in READS:
        raise ValueError(f"mode must be one of {MODES} and read one of "
                         f"{READS}, got {mode!r}, {read!r}")
    if not -(1 << 31) <= int(init) < 1 << 31:
        raise ValueError(f"init {init} does not fit int32")
    if _on_cpu(v, *sides):
        return sec_stream_plain(v, sides, sched.steps, mode, read, init)
    is32, wide = _check_inputs(v, sides, sched, read,
                               (torch.uint16, torch.int32))
    steps = sched.steps
    out = torch.full((steps.nout * steps.h, LANES), int(init),
                     dtype=torch.int32, device=v.device)
    _launch("probe_sec_stream", v, sides, sched, out, MODES.index(mode),
            int(read == "full"), is32, wide, int(init))
    return out


def sec_stream_f32(v: torch.Tensor, sides: Sequence[torch.Tensor],
                   sched: Schedule, init: float = 0.0) -> torch.Tensor:
    """The f32 section stream of ``perf_k2_streams.py``: (nout * h, 128)
    f32 (module doc).  Every side is touched; ``sched`` must be
    ``ordered``."""
    if _on_cpu(v, *sides):
        return sec_stream_f32_plain(v, sides, sched.steps, init)
    if not sched.ordered:
        raise ValueError("sec_stream_f32 needs an ordered schedule "
                         "(schedule(..., ordered=True))")
    is32, wide = _check_inputs(v, sides, sched, "touch",
                               (torch.uint16, torch.int32))
    steps = sched.steps
    out = torch.full((steps.nout * steps.h, LANES), float(init),
                     dtype=torch.float32, device=v.device)
    bits = struct.unpack("<i", struct.pack("<f", float(init)))[0]
    _launch("probe_sec_stream_f32", v, sides, sched, out, is32, wide, bits)
    return out
