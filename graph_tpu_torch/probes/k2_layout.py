"""Step lists and section layouts of the K2 stream-floor probes.

Every site of ``scripts/perf_k2_{io,io2,io3,io4,io5,streams}.py`` streams
sections of ``SEC_R`` = 512 rows x 128 lanes through a Pallas grid that
visits steps ``k`` in order (passes outside, steps inside).  Step k
computes on ``h`` rows of the contribution stream from row ``row0[k]`` and
adds into out block ``ob[k]`` (``h`` rows), which it first zeroes when
``zero[k]``.  A variant is that list of steps (:class:`Steps`) plus what
it adds (:mod:`graph_tpu_torch.probes.k2_kernels`).  The functions below
build each script's list from its own index maps, quirks included:

* ``perf_k2_io.py``: ``sec_mid[k] % 16 == 0`` zeroes (blocks 0 and 16 of
  its own layout; the other blocks accumulate across passes); variant F's
  out blocks 16-31 are never touched;
* ``perf_k2_io2.py``'s ``io2``: out block ``sec_mid[2k] // 2``, zeroed by
  ``sec_mid[k] != sec_mid[k-1]`` (k, not 2k);
* ``perf_k2_io3.py``'s ``copy6deep``: 512 rows computed at row 2048k, out
  block ``sec_mid[4k]``; ``copy1``/``copy6sk``: out block
  ``k % max(nmid, 2)``, written every step;
* out arrays of ``max(nmid, 2)`` blocks, some never written.

The section layout of a graph (:func:`sections`) stands in for the TPU
plan's: a mid is a block of ``MID`` = 65,536 destinations
(``graph_tpu/engine/kernels.py:46``) and gets ``max(1, ceil(in-edges /
65,536))`` sections.  The TPU plan's sections also carried its window
padding (the port's CSR has none), and its side streams were Benes routes,
which do not carry over: the port draws them at random.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

SEC_R = 512
LANES = 128
SEC = SEC_R * LANES
MID = 65536
#: The scripts' synthetic layouts: sections a mid.
IO_MID_EVERY = 16
STREAMS_MID_EVERY = 18
#: The five side streams of the TPU plan, in the scripts' order.
SIDE_NAMES = ("wa", "wb", "sstart", "wa2", "wb2")


@dataclasses.dataclass(frozen=True)
class Steps:
    """One grid pass of a variant, run ``passes`` times: step k computes
    on rows ``row0[k] : row0[k] + h`` and adds into out block ``ob[k]``
    (of ``nout`` blocks of ``h`` rows), zeroed first when ``zero[k]``."""

    row0: np.ndarray  # (S,) int64
    ob: np.ndarray    # (S,) int64
    zero: np.ndarray  # (S,) bool
    h: int
    nout: int
    passes: int = 1

    def __post_init__(self):
        s = len(self.row0)
        if not (self.row0.dtype == np.int64 and self.ob.dtype == np.int64
                and self.zero.dtype == np.bool_
                and self.row0.shape == self.ob.shape == self.zero.shape
                == (s,)):
            raise TypeError("row0, ob (int64) and zero (bool) must be "
                            "(S,) arrays")
        if self.h <= 0 or self.h % 8 or self.passes < 1 or self.nout < 1:
            raise ValueError(f"h={self.h} (a multiple of 8), passes="
                             f"{self.passes}, nout={self.nout}")
        if s and (self.ob.min() < 0 or self.ob.max() >= self.nout
                  or self.row0.min() < 0):
            raise ValueError("out blocks must lie in [0, nout) and rows "
                             "be nonnegative")

    @property
    def nsteps(self) -> int:
        return len(self.row0)

    @property
    def rows_needed(self) -> int:
        """Rows a stream must have for every step's rows."""
        return int(self.row0.max()) + self.h if self.nsteps else 0


def _steps(row0, ob, zero, h, nout, passes=1) -> Steps:
    return Steps(np.asarray(row0, np.int64), np.asarray(ob, np.int64),
                 np.asarray(zero, np.bool_), int(h), int(nout), int(passes))


def first_of_mid(sec_mid: np.ndarray) -> np.ndarray:
    """The scripts' ``first``: ``k == 0 | sm[k] != sm[max(k - 1, 0)]``."""
    sm = np.asarray(sec_mid)
    z = np.ones(len(sm), np.bool_)
    z[1:] = sm[1:] != sm[:-1]
    return z


def _outs(nmid: int) -> int:
    """The scripts' out arrays: ``max(nmid, 2)`` blocks."""
    return max(int(nmid), 2)


# ---- perf_k2_io.py ---------------------------------------------------------

IO_VARIANTS = ("A", "B", "C", "D", "E", "F")


def k2_io_steps(sec_mid: np.ndarray, variant: str, passes: int) -> Steps:
    """``perf_k2_io.py``: A (``main``'s copy, out block k), B and E
    (``_sink4_kernel``), C (``_sink4_nout_kernel``, out block k), D
    (``_sink1_kernel``), F (B on 2-section blocks: k < nsec/2 on rows
    1024k, out block ``sm[k]``); B, D, E, F zero where ``sm[k] % 16 ==
    0``, into ``nsec // 16`` out blocks."""
    sm = np.asarray(sec_mid, np.int64)
    nsec = len(sm)
    k = np.arange(nsec)
    if variant in ("A", "C"):
        return _steps(k * SEC_R, k, np.ones(nsec), SEC_R, nsec, passes)
    if variant in ("B", "D", "E"):
        return _steps(k * SEC_R, sm, sm % IO_MID_EVERY == 0, SEC_R,
                      nsec // IO_MID_EVERY, passes)
    if variant == "F":
        k = np.arange(nsec // 2)
        return _steps(k * 2 * SEC_R, sm[k], sm[k] % IO_MID_EVERY == 0,
                      2 * SEC_R, nsec // IO_MID_EVERY, passes)
    raise ValueError(f"variant must be one of {IO_VARIANTS}, got {variant!r}")


# ---- perf_k2_io2.py --------------------------------------------------------

IO2_MODES = ("io1", "io1_fixout", "io1_4s", "io1_2s", "io2")


def k2_io2_steps(sec_mid: np.ndarray, nmid: int, mode: str) -> Steps:
    """``perf_k2_io2.py``'s ``run_variant``: out block ``sm[k]`` (0 for
    ``io1_fixout``); ``io2`` computes 1024 rows at 1024k for k < nsec/2
    into block ``sm[2k] // 2``, zeroed by ``first`` at k."""
    sm = np.asarray(sec_mid, np.int64)
    nsec = len(sm)
    first = first_of_mid(sm)
    if mode == "io2":
        k = np.arange(nsec // 2)
        return _steps(k * 2 * SEC_R, sm[2 * k] // 2, first[k], 2 * SEC_R,
                      _outs(nmid))
    if mode not in IO2_MODES:
        raise ValueError(f"mode must be one of {IO2_MODES}, got {mode!r}")
    k = np.arange(nsec)
    ob = np.zeros(nsec, np.int64) if mode == "io1_fixout" else sm
    return _steps(k * SEC_R, ob, first, SEC_R, _outs(nmid))


# ---- perf_k2_io3.py --------------------------------------------------------

IO3_VARIANTS = ("copy1", "copy6", "copy6w", "copy6deep", "copy6sk",
                "copy6noq")


def k2_io3_steps(sec_mid: np.ndarray, nmid: int, variant: str) -> Steps:
    """``perf_k2_io3.py``'s ``mk``: ``"acc"`` variants add into block
    ``sm[k * step]`` zeroed by ``first`` at k (``copy6deep``: step 4, 512
    rows computed at row 2048k); ``"step"`` variants (``copy1``,
    ``copy6sk``) write block ``k % max(nmid, 2)`` every step."""
    sm = np.asarray(sec_mid, np.int64)
    nsec = len(sm)
    if variant not in IO3_VARIANTS:
        raise ValueError(f"variant must be one of {IO3_VARIANTS}, "
                         f"got {variant!r}")
    step = 4 if variant == "copy6deep" else 1
    k = np.arange(nsec // step)
    if variant in ("copy1", "copy6sk"):
        return _steps(k * SEC_R, k % _outs(nmid), np.ones(len(k)), SEC_R,
                      _outs(nmid))
    return _steps(k * step * SEC_R, sm[k * step], first_of_mid(sm)[k],
                  SEC_R, _outs(nmid))


# ---- perf_k2_io4.py --------------------------------------------------------

def k2_io4_multipass_steps(sec_mid: np.ndarray, nmid: int,
                           passes: int) -> Steps:
    """``mk_multipass``: grid (r, nsec) in one call, out block ``sm[k]``
    zeroed by ``first`` at ``program_id(1)``, so every pass starts its
    blocks afresh."""
    sm = np.asarray(sec_mid, np.int64)
    k = np.arange(len(sm))
    return _steps(k * SEC_R, sm, first_of_mid(sm), SEC_R, _outs(nmid),
                  passes)


def acc_steps(sec_mid: np.ndarray, nmid: int) -> Steps:
    """One pass into block ``sm[k]`` zeroed by ``first``: ``mk_onepass``,
    ``perf_k2_io3.py``'s ``copy6`` and ``perf_k2_io5.py``'s reads."""
    return k2_io4_multipass_steps(sec_mid, nmid, 1)


# ---- perf_k2_io5.py --------------------------------------------------------

IO5_VARIANTS = ("read1", "read2", "read4", "read6", "read6n")


def k2_io5_steps(sec_mid: np.ndarray, nmid: int, variant: str) -> Steps:
    """``perf_k2_io5.py``'s ``mk``: ``"acc"`` as :func:`acc_steps`;
    ``read6n`` writes block ``k % max(nmid, 2)`` every step."""
    if variant not in IO5_VARIANTS:
        raise ValueError(f"variant must be one of {IO5_VARIANTS}, "
                         f"got {variant!r}")
    if variant == "read6n":
        k = np.arange(len(sec_mid))
        return _steps(k * SEC_R, k % _outs(nmid), np.ones(len(k)), SEC_R,
                      _outs(nmid))
    return acc_steps(sec_mid, nmid)


# ---- perf_k2_streams.py ----------------------------------------------------

def streams_layout(nsec: int) -> tuple:
    """``perf_k2_streams.py``'s ``sec_mid = arange(NSEC) // 18`` and
    ``nmid = NSEC // 18 + 1`` (its out array, of which the last block is
    never touched when 18 divides NSEC)."""
    return (np.arange(nsec, dtype=np.int32) // STREAMS_MID_EVERY,
            nsec // STREAMS_MID_EVERY + 1)


def k2_streams_steps(sec_mid: np.ndarray, nmid: int) -> Steps:
    """``perf_k2_streams.py``'s ``bench``: out block ``sm[k]`` zeroed by
    ``first``, into exactly ``nmid`` blocks."""
    sm = np.asarray(sec_mid, np.int64)
    k = np.arange(len(sm))
    return _steps(k * SEC_R, sm, first_of_mid(sm), SEC_R, nmid)


# ---- section layouts -------------------------------------------------------

def sections(indptr, mid: int = MID) -> tuple:
    """``(sec_mid, nmid)`` of a destination-sorted CSR's row offsets
    ``indptr`` (n + 1 entries, numpy or a tensor): ``ceil(n / mid)`` mids,
    each with ``max(1, ceil(in-edges / 65,536))`` sections; ``sec_mid``
    (int32) lists the mid of each section, in order."""
    n = len(indptr) - 1
    nmid = max(1, -(-n // mid))
    at = np.minimum(np.arange(nmid + 1, dtype=np.int64) * mid, n)
    if isinstance(indptr, torch.Tensor):
        ends = indptr[torch.from_numpy(at).to(indptr.device)].cpu().numpy()
    else:
        ends = np.asarray(indptr)[at]
    per = np.maximum(1, -(-np.diff(ends.astype(np.int64)) // SEC))
    return np.repeat(np.arange(nmid, dtype=np.int32), per), nmid


def rmat_sections(scale: int, relabel: Optional[str], device) -> tuple:
    """:func:`sections` of Graph500 RMAT at ``scale`` (edge factor 16,
    seed 42, ``host_rmat``), planned on ``device`` with ``relabel``
    (``"degree"`` or None)."""
    from graph_tpu_torch.engine.plan import build_plan
    from graph_tpu_torch.generate import host_rmat

    src, dst = host_rmat(scale)
    plan = build_plan(src, dst, 1 << scale, relabel=relabel, device=device)
    return sections(plan.indptr)


def script_reps(nslots: int) -> int:
    """The RMAT scripts' calls a case: ``max(8, 1.2e9 // nslots)``."""
    return max(8, int(1.2e9 // nslots))


def rmat_inputs(nsec: int, device) -> tuple:
    """(contributions, the five side streams) of an ``nsec``-section
    layout, as :func:`contributions` and :func:`side_streams` make them."""
    v = contributions(nsec, device)
    return v, side_streams(v.shape[0], device)


def contributions(nsec: int, device, seed: int = 1) -> torch.Tensor:
    """The scripts' contribution stream: ``default_rng(1).random((nsec *
    512, 128)) * 1e-5`` as f32."""
    rng = np.random.default_rng(seed)
    c = (rng.random((nsec * SEC_R, LANES)) * 1e-5).astype(np.float32)
    return torch.from_numpy(c).to(device)


def side_streams(rows: int, device, count: int = 5,
                 seed: int = 5) -> list:
    """``count`` u16 (rows, 128) side streams, uniform, drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed`` (their
    values do not change what is timed)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randint(0, 1 << 16, (rows, LANES), generator=g,
                          dtype=torch.int32, device=device).to(torch.uint16)
            for _ in range(count)]
