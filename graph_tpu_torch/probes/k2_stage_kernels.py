"""The K2 stage probes' kernels, with their plain versions.

Counterparts of the seven Pallas sites of ``scripts/perf_k2_stages.py``,
``perf_k2v2_stages.py``, ``perf_k2_route_ops.py``, ``perf_k2_sec128.py``
and ``perf_transpose.py``, written by hand in CUDA C++ for Hopper as two
instances of one kernel (``graph_tpu_torch/csrc/k2_sections.cu``):
:func:`sec_route` runs sections of 512 rows x 128 lanes
(``probe_sec_route``, a cluster of eight blocks a section), :func:`sec128`
sections of 128 rows (``probe_sec128``, a cluster of two).  Each block
holds 64 rows of a section in registers, a warp four of them; a stage
that crosses rows takes one cluster barrier, and each side is fetched
once a section.

A variant is a **program**: a tuple of stages ``(op, a1, a2, a3)`` run on
each section a step reads, from ``v`` (rows, 128) f32 or int32 and up to
five side streams (rows, 128) u16 or u8, numbered 1 to 5 in the order
given.  The state X is the TPU kernel's (R, 128) array, int32 that wraps:

* ``("load", q, pad, layout)``: X = Q(v[rows]), ``q`` one of
  :data:`QUANT` (``"trunc"`` toward zero, ``"round"`` ``v * 2^30`` half to
  even, ``"int"`` the int32 values); with ``pad`` a side, f32 values where
  its bit 15 is set are first 0.0; ``layout`` 1 loads the array as the
  transposed (Y) layout of the route's middle (the inline C stage);
* ``("gather", s, shift)``: ``X[i, l] = X[i, (w_s[i, l] >> shift) &
  127]``; with ``s`` 0, ``X[i, (l + shift) & 127]``;
* ``("t",)``: ``swapaxes(X).reshape(R, 128)``; ``("ti",)`` its inverse;
* ``("c", s)``: ``X[i, j] = X[(i & ~3) | ((w_s[i, j] >> 7) & 3), j]``;
* ``("mask", s)``: X where bit 15 of w_s is set, else 0;
* ``("scan", s, L, Rs)``: the TPU's masked log-shift segmented sum with
  segment starts ``w_s``, truncated to L lane steps and Rs row steps
  (``graph_tpu/engine/kernels.py:413-464``; ``perf_k2_stages.py``'s
  ``stage_segscan_sum`` and ``perf_k2_sec128.py``'s ``_segscan128`` are
  the same steps: their extra guards ``lane >= sh``, ``rowid >= sh`` and
  ``rowid > 0`` follow from ``ss >= 0``, which u16 streams are);
* ``("psum",)``: the section's inclusive prefix sum, row-major (what
  ``stage_mxu_cumsum``'s 15-bit halves through the MXU compute exactly);
* ``("compact", s)``: ``k_compact``'s windows, from ``meta``;
* ``("add_full", s)``, ``("add_touch", s)`` (``w_s[row0, 0]``),
  ``("add_const", c)``.

The TPU computed route 1 on f32 and quantized after; its C stage (a sum of
seven selects) maps -0.0 to +0.0, which trunc and round send to 0 as they
do -0.0, so quantizing at ``load`` and routing quanta gives the same bits.

The epilogue is the stream probes': a list of
:class:`~graph_tpu_torch.probes.k2_layout.Steps` (``h`` = R) a output, each out block zeroed where a step
says, then added into (:func:`graph_tpu_torch.probes.k2_kernels.schedule`:
pieces, atomic adds for split chains, dead pieces computed and their
value dropped).  Blocks never zeroed or never touched start from ``init``.

Each wrapper runs its plain version for tensors on the CPU.  For CUDA
tensors it checks device, dtype, shape, contiguity and alignment (the
program's check and its words are cached), launches its kernel
on the current stream (building it at first use) and raises if the launch
reports an error; it never falls back to the plain version on the card.
``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from graph_tpu_torch.engine import _build
from graph_tpu_torch.probes import k2_kernels as kk
from graph_tpu_torch.probes.k2_layout import LANES, Steps
from graph_tpu_torch.probes.kernels import _check, _on_cpu

OPS = ("load", "gather", "t", "ti", "c", "mask", "scan", "psum", "compact",
       "add_full", "add_touch", "add_const")
QUANT = ("trunc", "round", "int")
MAX_OPS = 24
MAX_SIDES = 5
MAX_OUTS = 4
META_WORDS = 129
LANE_SHIFTS = (1, 2, 4, 8, 16, 32, 64)
#: Sections a piece of a block's chain: a cluster computes a whole section
#: a step, so short pieces spread a mid's chain over the card, and long
#: ones spread each piece's start (its first section read cold) and its
#: epilogue over more sections.
PIECE_STEPS = 8

#: Kernel launches since the last :func:`reset_launches`.  A wrapper adds
#: one where it launches its kernel, and nowhere else.
LAUNCHES = {"probe_sec_route": 0, "probe_sec128": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---- the variants' programs ------------------------------------------------

def route(wa: int, wb: int) -> tuple:
    """The Benes route (A, T, B, C, D, T', E) of ``_benes``, its packed
    stages in sides ``wa`` and ``wb``."""
    return (("gather", wa, 0), ("t",), ("gather", wb, 0), ("c", wb),
            ("gather", wb, 9), ("ti",), ("gather", wa, 7))


def route128(wa: int, m: int) -> tuple:
    """``perf_k2_sec128.py``'s ``_benes128``: A, T, the single middle
    gather by side ``m``, T', E."""
    return (("gather", wa, 0), ("t",), ("gather", m, 0), ("ti",),
            ("gather", wa, 7))


#: ``perf_k2_stages.py`` (sides wa, wb, ci): each kernel of ``bench``.
STAGES = {
    "io": (("load", "trunc"), ("add_full", 1), ("add_full", 2),
           ("add_full", 3)),
    "route": (("load", "trunc", 1), *route(1, 2), ("add_full", 3)),
    "mxucsum": (("load", "round", 1), *route(1, 2), ("psum",),
                ("add_full", 3)),
    "segscan": (("load", "round", 1), *route(1, 2), ("scan", 3, 7, 9)),
    "compact": (("load", "round", 1), *route(1, 2), ("psum",),
                ("compact", 3)),
}
_V2_TOUCH = tuple(("add_touch", s) for s in (2, 3, 4, 5))
#: ``perf_k2v2_stages.py`` (sides wa, wb, sstart, wa2, wb2): ``full`` is
#: K2 ``sum`` on f32 contributions, pads masked.
K2V2 = {
    "io": (("load", "round", 1), *_V2_TOUCH),
    "route1": (("load", "round", 1), *route(1, 2), *_V2_TOUCH),
    "scan": (("load", "round", 1), *route(1, 2), ("scan", 3, 7, 9),
             *_V2_TOUCH),
    "full": (("load", "round", 1), *route(1, 2), ("scan", 3, 7, 9),
             *route(4, 5), ("mask", 4)),
}
_RO_TOUCH = (("add_touch", 3), ("add_touch", 4), ("add_touch", 5))
_TRANSPOSE = (("load", "round"), ("gather", 1, 0), ("t",), ("gather", 2, 0))
#: ``perf_k2_route_ops.py`` (sides as ``K2V2``; no pad mask).  ``c_taa``
#: (``c_stage_taa``, a sublane gather) and ``c_roll`` (the seven selects)
#: compute one function on int32: the C stage.
ROUTE_OPS = {
    "io": (("load", "round"), *_RO_TOUCH),
    "taa1": (("load", "round"), ("gather", 1, 0), *_RO_TOUCH),
    "taa2": (("load", "round"), ("gather", 1, 0), ("gather", 2, 0),
             *_RO_TOUCH),
    "transpose": (*_TRANSPOSE, *_RO_TOUCH),
    "c_roll": (*_TRANSPOSE, ("c", 2), *_RO_TOUCH),
    "c_taa": (*_TRANSPOSE, ("c", 2), *_RO_TOUCH),
    "route1": (("load", "round"), *route(1, 2), *_RO_TOUCH),
    "route2only": (("load", "round"), *route(4, 5), ("add_touch", 2)),
    "both_routes": (("load", "round"), *route(1, 2), *route(4, 5),
                    ("add_touch", 3)),
}
#: ``perf_k2_route_ops.py:167``: the C stage alone on an int32 section
#: held as the route's middle array (side 1: wb).
C_ONLY = (("load", "int", 0, 1), ("c", 1))
#: K2 ``sum`` on int32 quanta (``k2_reduce``'s ``_k2_kernel``): the
#: ``sec512`` case of ``perf_k2_sec128.py``.
FULL_INT = (("load", "int"), *route(1, 2), ("scan", 3, 7, 9), *route(4, 5),
            ("mask", 4))
#: ``perf_transpose.py``'s bodies: (rows of a section, program).
TRANSPOSE = {
    "copy": (512, (("load", "int"), ("add_const", 1))),
    "t512x2": (512, (("load", "int"), ("t",), ("ti",))),
    "t128x8": (128, (("load", "int"), ("t",), ("ti",), ("add_const", 1))),
    "taa512": (512, (("load", "int"), ("gather", 0, 5))),
    "taa128x4": (128, (("load", "int"), ("gather", 0, 5))),
}


def sec128_program(stages: int = 4, lane_steps: int = 7,
                   row_steps: int = 7) -> tuple:
    """``k2_128``'s kernel (sides wa, m1, ss, wa2, m2; int32
    contributions) with ``stages`` 1-4 and the scan's truncation."""
    p = [("load", "int")]
    p += route128(1, 2) if stages >= 2 else [("add_full", 2)]
    p += ([("scan", 3, lane_steps, row_steps)] if stages >= 3
          else [("add_full", 3)])
    p += ([*route128(4, 5), ("mask", 4)] if stages >= 4
          else [("add_full", 4), ("add_full", 5)])
    return tuple(p)


def validate(program: Sequence[tuple], rows: int, nsides: int,
             has_meta: bool, v_dtype: torch.dtype) -> None:
    """Check a program for ``rows``-row sections: its stages, their sides
    and depths, and the layout each needs (scans, prefix sums and
    compaction the V layout, the C stage the Y layout of a 512-row
    section), tracked from ``load`` through every transpose."""
    if not 1 <= len(program) <= MAX_OPS or program[0][0] != "load":
        raise ValueError(f"a program is 1 to {MAX_OPS} stages starting "
                         f"with load, got {program!r}")
    layout = None

    def side(s, allow0=False):
        if not (allow0 and s == 0) and not 1 <= s <= nsides:
            raise ValueError(f"stage names side {s}, of {nsides}")

    for op in program:
        name, args = op[0], tuple(op[1:])
        if name not in OPS or len(args) > 3:
            raise ValueError(f"bad stage {op!r}")
        if name == "load":
            q, pad, lay = (args + (0, 0))[:3]
            if q not in QUANT or lay not in (0, 1) or layout is not None:
                raise ValueError(f"bad load {op!r} (one, first)")
            if (q == "int") != (v_dtype == torch.int32):
                raise ValueError(f"load {q!r} of {v_dtype} values")
            if pad:
                side(pad)
                if q == "int":
                    raise ValueError("a pad mask needs f32 values")
            layout = lay
        elif name == "gather":
            side(args[0], allow0=True)
            if not 0 <= args[1] < 16:
                raise ValueError(f"bad shift in {op!r}")
        elif name in ("t", "ti"):
            if layout != (0 if name == "t" else 1):
                raise ValueError(f"{name} in layout {layout}")
            layout = 1 - layout
        elif name == "c":
            side(args[0])
            if layout != 1 or rows != 512:
                raise ValueError("the C stage needs the Y layout of a "
                                 "512-row section")
        elif name in ("scan", "psum", "compact"):
            if layout != 0:
                raise ValueError(f"{name} needs the V layout")
            if name == "scan":
                side(args[0])
                if not (0 <= args[1] <= 7
                        and 0 <= args[2] <= int(math.log2(rows))):
                    raise ValueError(f"bad scan depth {op!r}")
            if name == "compact":
                side(args[0])
                if not has_meta or rows != 512:
                    raise ValueError("compact needs meta and 512 rows")
        elif name in ("mask", "add_full", "add_touch"):
            side(args[0])
        elif name == "add_const":
            if not -(1 << 31) <= int(args[0]) < 1 << 31:
                raise ValueError(f"constant of {op!r} does not fit int32")


#: The words of each program checked so far, by (program, rows, sides,
#: meta, dtype of v).
_WORDS: dict = {}


def checked_words(program: Sequence[tuple], rows: int, nsides: int,
                  has_meta: bool, v_dtype: torch.dtype) -> np.ndarray:
    """:func:`validate`, then :func:`encode`; the words are kept for the
    next call with the same arguments, and a program that fails is checked
    (and refused) again at every call."""
    key = (tuple(tuple(op) for op in program), rows, nsides, has_meta,
           v_dtype)
    words = _WORDS.get(key)
    if words is None:
        validate(program, rows, nsides, has_meta, v_dtype)
        words = _WORDS[key] = np.ascontiguousarray(encode(program))
    return words


def encode(program: Sequence[tuple]) -> np.ndarray:
    """The kernel's (nops, 4) int32 words: op, then its arguments."""
    words = np.zeros((len(program), 4), np.int32)
    for i, op in enumerate(program):
        words[i, 0] = OPS.index(op[0])
        args = list(op[1:])
        if op[0] == "load":
            args = [QUANT.index(args[0])] + list(args[1:])
        words[i, 1:1 + len(args)] = args
    return words


# ---- plain versions --------------------------------------------------------

def _wrap(x: torch.Tensor) -> torch.Tensor:
    return (torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)).to(
        torch.int32)


def _sections(v, sides, meta, program, row0: torch.Tensor,
              rows: int) -> torch.Tensor:
    """(S, rows, 128) int64: the program on the sections at ``row0``
    (sums unwrapped; equal to the kernel's mod 2^32)."""
    dev = v.device
    ridx = row0[:, None] + torch.arange(rows, device=dev)  # (S, rows)
    lane = torch.arange(LANES, device=dev)
    rowid = torch.arange(rows, device=dev)[:, None]

    def w(s, at=ridx):
        side = sides[s - 1]
        if side.dtype == torch.uint16:  # CUDA indexes no uint16: its bits
            return side.view(torch.int16)[at].to(torch.int64) & 0xFFFF
        return side[at].to(torch.int64)

    x = None
    for op in program:
        name = op[0]
        if name == "load":
            q, pad = (tuple(op[1:]) + (0,))[:2]
            val = v[ridx]
            if q == "int":
                x = val.to(torch.int64)
                continue
            if pad:
                val = torch.where((w(pad) >> 15) & 1 == 1,
                                  torch.zeros((), device=dev), val)
            if q == "round":
                val = torch.round(val * float(1 << 30))
            x = val.to(torch.int32).to(torch.int64)
        elif name == "gather":
            s, shift = op[1], op[2]
            idx = (w(s) >> shift) & 127 if s else (
                (lane + shift) & 127).expand_as(x)
            x = torch.take_along_dim(x, idx, 2)
        elif name == "t":
            x = x.transpose(1, 2).reshape(-1, rows, LANES)
        elif name == "ti":
            x = x.reshape(-1, LANES, rows).transpose(1, 2)
        elif name == "c":
            src = (rowid & ~3) | ((w(op[1]) >> 7) & 3)
            x = torch.take_along_dim(x, src, 1)
        elif name == "mask":
            x = torch.where((w(op[1]) >> 15) & 1 == 1, x, 0)
        elif name == "scan":
            x = _scan_plain(x, w(op[1]), op[2], op[3])
        elif name == "psum":
            x = torch.cumsum(x.reshape(len(x), -1), 1).view_as(x)
        elif name == "compact":
            x = _compact_plain(x, w(op[1]), meta, row0 // rows)
        elif name == "add_full":
            x = x + w(op[1])
        elif name == "add_touch":
            x = x + w(op[1], (row0, 0))[:, None, None]
        else:
            x = x + int(op[1])
    return x.contiguous()


def _scan_plain(q, ss, lane_steps, row_steps):
    """``_segmented_scan(q, ss, "sum", lane_steps, row_steps)`` batched."""
    rows = q.shape[1]
    dev = q.device
    lane = torch.arange(LANES, device=dev)
    rowid = torch.arange(rows, device=dev)[:, None]
    local_start = ss - rowid * LANES
    lane_d = lane - local_start.clamp(min=0)
    for sh in LANE_SHIFTS[:lane_steps]:
        q = q + torch.where(lane_d >= sh, torch.roll(q, sh, 2), 0)
    if row_steps == 0:
        return q
    run = q[:, :, LANES - 1]
    row_d = torch.arange(rows, device=dev) - ss[:, :, LANES - 1] // LANES
    for sh in [1 << k for k in range(row_steps)]:
        run = run + torch.where(row_d >= sh, torch.roll(run, sh, 1), 0)
    carry = torch.roll(run, 1, 1)[:, :, None]
    return q + torch.where(local_start < 0, carry, 0)


def _compact_plain(c, ci, meta, sec):
    """``k_compact``'s loop: tile t = r // 8 reads ``c[base // 128 + hi,
    lo]`` where ``0 <= hi < 8 * nsb``, with ``local = ci - base``."""
    rows = c.shape[1]
    m = meta.view(-1, META_WORDS)[sec].to(torch.int64)  # (S, 129)
    t = torch.arange(rows, device=c.device) // 8
    base = m[:, 1 + t][:, :, None]
    nsb = m[:, 65 + t][:, :, None]
    local = ci - base
    hi, lo = local >> 7, local & 127
    ok = (hi >= 0) & (hi < 8 * nsb)
    at = ((base // 128 + hi) * LANES + lo).clamp(0, rows * LANES - 1)
    g = torch.take_along_dim(c.reshape(len(c), -1), at.reshape(len(c), -1),
                             1).view_as(c)
    return torch.where(ok, g, 0)


#: Sections the plain version computes at once.
PLAIN_CHUNK = 64


def stage_plain(v: torch.Tensor, sides: Sequence[torch.Tensor],
                program: Sequence[tuple], steps_list: Sequence[Steps],
                meta: Optional[torch.Tensor] = None,
                init: int = 0) -> list:
    """Plain version of :func:`sec_route` / :func:`sec128`: one
    (nout * h, 128) int32 output a :class:`Steps`.  Each distinct step's
    section is computed once (its program's value does not depend on the
    pass), then the grid's sequence of zeroes and adds is applied."""
    outs = []
    for steps in steps_list:
        rows = steps.h
        row0 = torch.from_numpy(steps.row0).to(v.device)
        q = torch.cat([_sections(v, sides, meta, program, row0[i:i + PLAIN_CHUNK],
                                 rows).reshape(-1, rows * LANES)
                       for i in range(0, len(row0), PLAIN_CHUNK)]) \
            if len(row0) else torch.zeros(0, rows * LANES, dtype=torch.int64,
                                          device=v.device)
        out = torch.full((steps.nout, rows * LANES), int(init),
                         dtype=torch.int64, device=v.device)
        kk._apply(out, q, steps)
        outs.append(_wrap(out).view(-1, LANES))
    return outs


# ---- the schedule ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageSchedule:
    """The pieces of up to four outputs' steps in one table: each
    output's :func:`~graph_tpu_torch.probes.k2_kernels.schedule`, its
    chain offsets shifted and its index in bits 8-9 of the piece word;
    ``meta`` the compaction windows, checked, or None; ``stored`` whether
    each output's every block is written whole by a piece that stores it
    (the wrapper then need not fill that output with ``init``)."""

    steps: tuple
    pieces: torch.Tensor
    chain: torch.Tensor
    sink: torch.Tensor
    meta: Optional[torch.Tensor]
    stored: tuple

    @property
    def device(self) -> torch.device:
        return self.chain.device


def check_meta(meta: np.ndarray, nsec: int, rows: int = 512) -> None:
    """``perf_k2_stages.py``'s ``meta`` (nsec * 129 int32) for ``nsec``
    sections: every tile's window ``base // 128 + [0, 8 * nsb)`` inside
    the section (the TPU would read past its scratch), base >= 0."""
    m = np.asarray(meta)
    if m.dtype != np.int32 or m.ndim != 1 or m.size < nsec * META_WORDS:
        raise ValueError(f"meta must be (>= {nsec * META_WORDS},) int32")
    m = m[:nsec * META_WORDS].reshape(nsec, META_WORDS).astype(np.int64)
    base, nsb = m[:, 1:65], m[:, 65:129]
    if (base < 0).any() or (nsb < 0).any() or (
            base // 128 + 8 * nsb > rows).any():
        raise ValueError("meta: windows must lie inside the section")


def schedule(steps_list: Sequence[Steps], device,
             meta: Optional[np.ndarray] = None) -> StageSchedule:
    """The schedule of one to four outputs' steps (one output a
    :class:`Steps`), with ``meta`` (numpy, checked by :func:`check_meta`
    for every section the steps read) for ``compact``."""
    if not 1 <= len(steps_list) <= MAX_OUTS:
        raise ValueError(f"1 to {MAX_OUTS} outputs, got {len(steps_list)}")
    pieces, chains, stored, off = [], [], [], 0
    for i, steps in enumerate(steps_list):
        s = kk.schedule(steps, "cpu", piece_steps=PIECE_STEPS)
        p = s.pieces.clone()
        blocks = p[(p[:, 3] & 15) == kk.STORE, 0]
        stored.append(bool(torch.equal(torch.unique(blocks),
                                       torch.arange(steps.nout))))
        p[:, 1] += off
        p[:, 3] |= i << 8
        pieces.append(p)
        chains.append(s.chain)
        off += len(s.chain)
    dev = torch.device(device)
    mt = None
    if meta is not None:
        need = max(s.rows_needed for s in steps_list)
        check_meta(meta, -(-need // steps_list[0].h), steps_list[0].h)
        mt = torch.from_numpy(np.ascontiguousarray(meta)).to(dev)
    return StageSchedule(tuple(steps_list), torch.cat(pieces).to(dev),
                         torch.cat(chains).to(dev),
                         torch.zeros(1, dtype=torch.int32, device=dev), mt,
                         tuple(stored))


# ---- bytes and operations --------------------------------------------------

def _sides_read(program) -> tuple:
    full, touched = set(), set()
    for op in program:
        name = op[0]
        if name == "load" and len(op) > 2 and op[2]:
            full.add(op[2])
        elif name in ("gather",) and op[1]:
            full.add(op[1])
        elif name in ("c", "mask", "scan", "compact", "add_full"):
            full.add(op[1])
        elif name == "add_touch":
            touched.add(op[1])
    return full, touched - full


def moved_bytes(program, steps_list: Sequence[Steps], v: torch.Tensor,
                sides: Sequence[torch.Tensor]) -> int:
    """Bytes a variant must move: every step's rows of v and of each side
    the program reads in full, one element of each touched side and the
    step's 129 meta words (compaction) a step, over its passes; each out
    block written once."""
    full, touched = _sides_read(program)
    total = 0
    for steps in steps_list:
        n = steps.nsteps * steps.passes
        slots = n * steps.h * LANES
        total += slots * (v.element_size() + sum(
            sides[s - 1].element_size() for s in full))
        total += n * sum(sides[s - 1].element_size() for s in touched)
        if any(op[0] == "compact" for op in program):
            total += 4 * META_WORDS * n
        total += 4 * steps.nout * steps.h * LANES
    return total


def operations(program, steps_list: Sequence[Steps]) -> int:
    """Integer operations a slot, over every step: one a quantize, add,
    mask and compaction select, one a scan step and a prefix-sum step
    (data movement, the gathers and transposes, counts none)."""
    per = 0
    for op in program:
        name = op[0]
        if name == "load":
            per += op[1] != "int"
        elif name in ("mask", "compact", "add_full", "add_touch",
                      "add_const"):
            per += 1
        elif name == "scan":
            per += op[2] + (op[3] > 0)
        elif name == "psum":
            per += 8
    return per * sum(s.nsteps * s.passes * s.h * LANES for s in steps_list)


# ---- wrappers --------------------------------------------------------------

def _run(name: str, rows: int, v, sides, program, sched: StageSchedule,
         init: int) -> list:
    steps_list, meta = sched.steps, sched.meta
    for steps in steps_list:
        if steps.h != rows:
            raise ValueError(f"steps of {steps.h} rows, sections of {rows}")
    if len(sides) > MAX_SIDES:
        raise ValueError(f"at most {MAX_SIDES} sides, got {len(sides)}")
    if not -(1 << 31) <= int(init) < 1 << 31:
        raise ValueError(f"init {init} does not fit int32")
    words = checked_words(program, rows, len(sides), meta is not None,
                          v.dtype)
    if _on_cpu(v, *sides):
        return stage_plain(v, sides, program, steps_list, meta, init)
    dev = v.device
    if sched.device != dev:
        raise ValueError(f"schedule is on {sched.device}, v on {dev}")
    need = max(s.rows_needed for s in steps_list)
    # the kernel reads 4 elements of a row at once
    _check("v", v, (torch.float32, torch.int32), dev,
           v.dim() == 2 and v.shape[1] == LANES and v.shape[0] >= need,
           f"(>= {need}, 128)", 16)
    u8mask = 0
    for i, s in enumerate(sides):
        _check(f"side {i + 1}", s, (torch.uint16, torch.uint8), dev,
               s.dim() == 2 and s.shape[1] == LANES and s.shape[0] >= need,
               f"(>= {need}, 128)", s.element_size() * 4)
        u8mask |= (s.dtype == torch.uint8) << i
    # outputs whose every block a piece stores whole are left unfilled
    outs = [torch.empty((s.nout * rows, LANES), dtype=torch.int32,
                        device=dev) if whole else
            torch.full((s.nout * rows, LANES), int(init), dtype=torch.int32,
                       device=dev)
            for s, whole in zip(steps_list, sched.stored)]
    if sched.pieces.shape[0]:
        ptrs = [s.data_ptr() for s in sides] + [None] * (MAX_SIDES - len(sides))
        optrs = [o.data_ptr() for o in outs] + [None] * (MAX_OUTS - len(outs))
        fn = _build.load(name)
        with torch.cuda.device(dev):
            err = fn(v.data_ptr(), *ptrs,
                     None if meta is None else meta.data_ptr(), *optrs,
                     sched.pieces.data_ptr(), sched.chain.data_ptr(),
                     sched.sink.data_ptr(), words.ctypes.data,
                     sched.pieces.shape[0], len(words),
                     int(v.dtype == torch.float32), u8mask, int(init),
                     torch.cuda.current_stream(dev).cuda_stream)
        LAUNCHES[name] += 1
        if err != 0:
            raise RuntimeError(f"{name}: kernel launch failed with CUDA "
                               f"error {err}")
    return outs


def sec_route(v: torch.Tensor, sides: Sequence[torch.Tensor],
              program: Sequence[tuple], sched: StageSchedule,
              init: int = 0) -> torch.Tensor:
    """A program on 512-row sections (module doc): (nout * 512, 128)
    int32.  v: (rows, 128) f32 or int32; sides: up to five (rows, 128) u16
    or u8; ``sched`` from :func:`schedule` of one :class:`Steps` with ``h
    = 512`` (and ``meta`` for ``compact``).  :func:`sec_route_outs` takes
    one to four."""
    if len(sched.steps) != 1:
        raise ValueError("sec_route writes one output; sec_route_outs more")
    return sec_route_outs(v, sides, program, sched, init)[0]


def sec_route_outs(v: torch.Tensor, sides: Sequence[torch.Tensor],
                   program: Sequence[tuple], sched: StageSchedule,
                   init: int = 0) -> list:
    """:func:`sec_route` into one to four outputs, as :func:`sec128`: a
    list of (nout * 512, 128) int32, one a :class:`Steps` of ``sched``."""
    return _run("probe_sec_route", 512, v, sides, program, sched, init)


def sec128(v: torch.Tensor, sides: Sequence[torch.Tensor],
           program: Sequence[tuple], sched: StageSchedule,
           init: int = 0) -> list:
    """A program on 128-row sections into one to four outputs (``k2_quad``
    writes four): a list of (nout * 128, 128) int32, one a :class:`Steps`
    of ``sched``."""
    return _run("probe_sec128", 128, v, sides, program, sched, init)
