"""The EdgeEngine's kernels: K1 (gather) and K2 (segment reduce).

Counterparts of ``graph_tpu.engine.kernels.k1_gather`` and ``k2_reduce``,
written by hand in CUDA C++ for Hopper (``graph_tpu_torch/csrc/k1_gather.cu``
and ``k2_reduce.cu``).  The plan (:mod:`graph_tpu_torch.engine.plan`)
stores slots sorted by destination with row offsets, so:

* K1 :func:`k1_gather`: ``contrib[i] = xq[slot_src[i]]`` for every slot,
  any 4-byte values (int32 quanta, int32 labels, f32 bit patterns);
* K1 :func:`k1_gather_weighted`: ``x[slot_src[i]] + w[i]`` or ``* w[i]``
  in f32, written as f32 or quantized to int32;
* K2 :func:`k2_reduce`: ``y[d] = sum(contrib[indptr[d]:indptr[d+1]])``
  with int32 wraparound; empty rows give 0;
* K2 :func:`k2_reduce_min`: the row's int32 min, no larger than the op's
  fill (``IMAX`` for ``op="imin"``, ``INF_BITS`` for ``op="min"`` over
  f32 bit patterns); empty rows give the fill.

Two arguments shape the kernels' work and never their results.  K1's
``window`` is how many of the first sources each block keeps in shared
memory (the hottest ones, on a degree-relabeled plan).  K2's ``cuts``
(:func:`k2_tile_cuts`) cut the merged sequence of row ends and slots into
tiles of equal size; a caller that reduces over one ``indptr`` many times
computes them once and passes them in.

Sums are int32 fixed point, ``round(x * 2**FIXED_BITS)``; integer
addition and min do not depend on order, so every reduction order gives
the same bits as the JAX package.

Around K1 and K2, PageRank's Jacobi iteration on the plan engine runs its
n-sized work in two kernels of its own (``csrc/jacobi_tails.cu``):
:func:`jacobi_quantize` makes the quanta K1 gathers, and
:func:`jacobi_update` makes the new scores from K2's sums, with the
residual.

Triangle count's join is one kernel (``csrc/tc_count.cu``):
:func:`tc_count` intersects each forward list, staged on chip, with its
neighbours' lists, over the heads :func:`tc_schedule` sorts into long
ones (a block each) and short ones (a warp each).

Delta-stepping's settle step on the card is one kernel over on-card
near/far queues (``csrc/sssp_frontier.cu``): :func:`sssp_frontier_relax`
relaxes the out-arcs of the current near queue's nodes, appending each
node it lowers to the next near queue or the far pile, and
:func:`sssp_frontier_advance` moves the next bucket's entries of the far
pile into the near queue; :func:`sssp_frontier_reset` starts a run.  They
work in place on a :class:`NearFar` state (:func:`near_far_state`).

Each wrapper runs its plain PyTorch version for tensors on the CPU.  For
CUDA tensors it checks device, dtype, shape and contiguity, launches its
kernel on the current stream (building it at first use) and raises if
the launch reports an error.  It never falls back to the plain version
on the card.  ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch

from graph_tpu_torch.engine import _build, tc_join

FIXED_BITS = 30  # fixed-point fraction bits
INF = 3.0e38  # the min paths' +inf stand-in, as in graph_tpu
INF_BITS = 2137108966  # float32(INF) viewed as int32
IMAX = 2147483647  # int32 max: the "+inf" of the integer-min path
#: The fill of each K2 min op: the value of an empty row.
MIN_FILL = {"imin": IMAX, "min": INF_BITS}

#: Largest K1 window: 232,448 bytes of shared memory per block, 4 per source.
K1_WINDOW_MAX = 232_448 // 4
#: The K1 window the engine gives degree-relabeled plans: the first 49,152
#: internal ids (192 KB), the sources of about 60% of the slots at RMAT
#: scale 22; the fastest of the windows chip_smoke's probe times (PERF.md).
K1_WINDOW = 49_152
#: Merged items (row ends and slots) per K2 tile: 128 threads x 15, the
#: ``kTile`` of ``csrc/k2_reduce.cu``.
K2_TILE = 1920

#: Kernel launches since the last :func:`reset_launches`.  A wrapper adds
#: one where it launches its kernel, and nowhere else.
LAUNCHES = {"k1_gather": 0, "k1_gather_weighted": 0, "k2_reduce": 0,
            "k2_reduce_min": 0, "jacobi_quantize": 0, "jacobi_update": 0,
            "tc_count": 0, "sssp_frontier_reset": 0,
            "sssp_frontier_relax": 0, "sssp_frontier_advance": 0}
#: The device function each wrapper launches once a call, as a pattern over
#: mangled kernel names: a captured graph's kernel nodes are counted by it
#: (:mod:`graph_tpu_torch.engine.loop`).
KERNEL_NODES = {"k1_gather": r"k1_gather_kernel",
                "k1_gather_weighted": r"k1_gather_weighted_kernel",
                "k2_reduce": r"k2_tile_kernel.*SumOp",
                "k2_reduce_min": r"k2_tile_kernel.*MinOp",
                "jacobi_quantize": r"jacobi_quantize_kernel",
                "jacobi_update": r"jacobi_update_kernel",
                "tc_count": r"tc_count_kernel",
                "sssp_frontier_reset": r"sssp_reset_kernel",
                "sssp_frontier_relax": r"sssp_relax_kernel",
                "sssp_frontier_advance": r"sssp_advance_kernel"}
#: Threads a block of the Jacobi tail kernels, the ``kThreads`` of
#: ``csrc/jacobi_tails.cu``, and the most blocks a launch takes.
JACOBI_THREADS = 256
JACOBI_MAX_BLOCKS = 4096
#: Heads with more forward edges than this are a block's work in
#: :func:`tc_count`; heads with 2 to this many, a warp's.
TC_LONG = 64
#: The most targets of one forward list that :func:`tc_count` stages at
#: once, a block's and a warp's (the ``tile`` of ``BlockShape`` and
#: ``WarpShape`` in ``csrc/tc_count.cu``); a longer list is counted tile by
#: tile.
TC_TILE = 1024
TC_WARP_TILE = 64
#: Arcs a tile of :func:`sssp_frontier_relax` (the ``kTile`` of
#: ``csrc/sssp_frontier.cu``): a near queue records, for each tile of its
#: arcs, the entry the tile's first arc belongs to.
NEAR_FAR_TILE = 256
#: The near-far queues count arcs in 32 bits: a graph takes the card path
#: below this many arcs.
NEAR_FAR_MAX_ARCS = (1 << 32) - NEAR_FAR_TILE
#: The int64 words of a :class:`NearFar`'s ``ctrl`` (the ``Ctrl`` of
#: ``csrc/sssp_frontier.cu``): the heads of near queues 0 and 1, each
#: ``(entries << 32) | arcs``; the arcs relaxed; the near queue the next
#: step reads; that step's number; the bucket; the far pile the steps
#: append to; the counts of far piles 0 and 1; their least buckets; the
#: kernels' last-block ticket (blocks finished, near entries appended).
HEAD, RELAXED, CUR, STEP, BUCKET, FC, FAR_COUNT, FAR_MIN, TICKET = (
    0, 2, 3, 4, 5, 6, 7, 9, 11)
#: Bucket numbers clamp here before the int cast: f32::MAX / delta
#: overflows int32.
BIN_CLAMP = 2147483520.0  # f32(2**31 - 128)
#: f32::MAX, an unreached node's distance.
F32_MAX = 3.4028234663852886e38


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def k1_gather_plain(xq: torch.Tensor, slot_src: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: ``xq[slot_src]``."""
    return xq[slot_src.long()]


def k1_gather_weighted_plain(x: torch.Tensor, slot_src: torch.Tensor,
                             w: torch.Tensor, combine: str,
                             quantize: bool) -> torch.Tensor:
    """Plain version of weighted K1: ``x[src] + w`` or ``x[src] * w`` in
    f32, then ``round(v * 2**FIXED_BITS)`` as int32 when quantizing."""
    xs = x[slot_src.long()]
    v = xs + w if combine == "add" else xs * w
    if quantize:
        return torch.round(v * float(1 << FIXED_BITS)).to(torch.int32)
    return v


def k2_reduce_plain(contrib: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: row sums in int64, wrapped to int32 explicitly."""
    csum = torch.zeros(contrib.numel() + 1, dtype=torch.int64,
                       device=contrib.device)
    torch.cumsum(contrib.to(torch.int64), 0, out=csum[1:])
    acc = csum[indptr[1:]] - csum[indptr[:-1]]
    return (((acc + 2**31) % 2**32) - 2**31).to(torch.int32)


def k2_reduce_min_plain(contrib: torch.Tensor, indptr: torch.Tensor,
                        op: str) -> torch.Tensor:
    """Plain version of K2's min: ``scatter_reduce_`` of the row mins into
    the op's fill."""
    n = indptr.numel() - 1
    rows = torch.repeat_interleave(
        torch.arange(n, device=contrib.device), torch.diff(indptr))
    y = torch.full((n,), MIN_FILL[op], dtype=torch.int32, device=contrib.device)
    return y.scatter_reduce_(0, rows, contrib, "amin")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor, "
                         f"got shape {tuple(t.shape)}")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


#: Per thread, the launches of the capture it is making
#: (:func:`captured_launches`), or none.
_CAPTURED = threading.local()


@contextlib.contextmanager
def captured_launches():
    """While the block runs, count this thread's launches apart from
    ``LAUNCHES``, in the dict it yields (kernel -> launches): a capture's
    launches record kernel nodes and run nothing, and another thread's
    launches meanwhile still go to ``LAUNCHES``."""
    outer = getattr(_CAPTURED, "counts", None)
    counts = _CAPTURED.counts = dict.fromkeys(LAUNCHES, 0)
    try:
        yield counts
    finally:
        _CAPTURED.counts = outer


def _launch(name: str, device: torch.device, *args) -> None:
    fn = _build.load(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    counts = getattr(_CAPTURED, "counts", None)
    (LAUNCHES if counts is None else counts)[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def _window(window: int, n_src: int) -> int:
    """The K1 window actually staged: ``window`` capped at the sources."""
    if not 0 <= window <= K1_WINDOW_MAX:
        raise ValueError(f"window must lie in [0, {K1_WINDOW_MAX}], "
                         f"got {window}")
    return min(int(window), n_src)


def k1_gather(xq: torch.Tensor, slot_src: torch.Tensor,
              window: int = 0) -> torch.Tensor:
    """Per-slot gather: ``out[i] = xq[slot_src[i]]``.

    xq: (n_src,) int32 (quanta, labels, or f32 values viewed as int32);
    slot_src: (m,) int32 indices into xq, as a plan stores them (the plan
    checks their range when it is built).  ``window``: the kernel serves
    sources below it from shared memory (at most ``K1_WINDOW_MAX``; 0
    turns it off).  Returns (m,) int32.
    """
    h = _window(window, xq.numel())
    if _on_cpu(xq, slot_src):
        return k1_gather_plain(xq, slot_src)
    _check("xq", xq, torch.int32, xq.device)
    _check("slot_src", slot_src, torch.int32, xq.device)
    out = torch.empty_like(slot_src)
    if out.numel():
        _launch("k1_gather", xq.device, xq.data_ptr(), slot_src.data_ptr(),
                out.data_ptr(), out.numel(), h)
    return out


def k1_gather_weighted(x: torch.Tensor, slot_src: torch.Tensor,
                       w: torch.Tensor, combine: str,
                       quantize: bool, window: int = 0) -> torch.Tensor:
    """Per-slot gather with an edge weight, in f32:
    ``v[i] = x[slot_src[i]] + w[i]`` (``combine="add"``) or ``* w[i]``
    (``"mul"``).

    x: (n_src,) f32; slot_src: (m,) int32; w: (m,) f32; ``window`` as for
    :func:`k1_gather`.  Returns (m,) f32 ``v``, or with ``quantize`` the
    (m,) int32 quanta ``round_half_even(v * 2**FIXED_BITS)`` that
    :func:`k2_reduce` sums (|v| must stay below 2**(31-FIXED_BITS)).
    """
    if combine not in ("add", "mul"):
        raise ValueError(f"combine must be add|mul, got {combine!r}")
    h = _window(window, x.numel())
    if _on_cpu(x, slot_src, w):
        return k1_gather_weighted_plain(x, slot_src, w, combine, quantize)
    _check("x", x, torch.float32, x.device)
    _check("slot_src", slot_src, torch.int32, x.device)
    _check("w", w, torch.float32, x.device)
    if w.numel() != slot_src.numel():
        raise ValueError(f"w has {w.numel()} slots, slot_src "
                         f"{slot_src.numel()}")
    out = torch.empty(slot_src.numel(), device=x.device,
                      dtype=torch.int32 if quantize else torch.float32)
    if out.numel():
        _launch("k1_gather_weighted", x.device, x.data_ptr(),
                slot_src.data_ptr(), w.data_ptr(), out.data_ptr(),
                out.numel(), h, int(combine == "mul"), int(bool(quantize)))
    return out


def k2_num_tiles(n: int, m: int) -> int:
    """K2's tile count for n rows and m slots: enough tiles of at most
    ``K2_TILE`` merged items, and at least one."""
    return max(1, -(-(n + m) // K2_TILE))


def k2_tile_cuts(indptr: torch.Tensor, m: int) -> torch.Tensor:
    """Where each K2 tile starts, on the merge path of row ends and slots.

    The merged sequence lists each row's slots, then its end: row d's end
    is item ``indptr[d+1] + d`` of ``n + m``.  Tile t of T =
    :func:`k2_num_tiles` covers items ``[D(t), D(t+1))`` with
    ``D(t) = t * (n + m) // T``, so tiles differ by at most one item.
    Returns (T+1,) int64 ``cuts``: ``cuts[t]`` rows end before ``D(t)``,
    and the tile's first slot is ``D(t) - cuts[t]``.  indptr: (n+1,)
    int64 from 0 to m.
    """
    n = indptr.numel() - 1
    ntiles = k2_num_tiles(n, m)
    diag = torch.arange(ntiles + 1, dtype=torch.int64,
                        device=indptr.device) * (n + m) // ntiles
    ends = indptr[1:] + torch.arange(n, dtype=torch.int64,
                                     device=indptr.device)
    return torch.searchsorted(ends, diag)


def _reduce_out(contrib: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    _check("contrib", contrib, torch.int32, contrib.device)
    _check("indptr", indptr, torch.int64, contrib.device)
    if indptr.numel() < 1:
        raise ValueError("indptr needs at least one offset")
    return torch.empty(indptr.numel() - 1, dtype=torch.int32,
                       device=contrib.device)


def _launch_k2(name: str, contrib: torch.Tensor, indptr: torch.Tensor,
               cuts, out: torch.Tensor, *options) -> None:
    n, m = out.numel(), contrib.numel()
    if cuts is None:
        cuts = k2_tile_cuts(indptr, m)
    _check("cuts", cuts, torch.int64, contrib.device)
    ntiles = cuts.numel() - 1
    if ntiles != k2_num_tiles(n, m):
        raise ValueError(f"cuts has {ntiles} tiles, n={n} and m={m} take "
                         f"{k2_num_tiles(n, m)}")
    carries = torch.empty(ntiles, dtype=torch.int32, device=contrib.device)
    _launch(name, contrib.device, contrib.data_ptr(), indptr.data_ptr(),
            cuts.data_ptr(), carries.data_ptr(), out.data_ptr(), n, m,
            ntiles, *options)


def k2_reduce(contrib: torch.Tensor, indptr: torch.Tensor,
              cuts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row wraparound sum: ``y[d] = sum(contrib[indptr[d]:indptr[d+1]])``.

    contrib: (m,) int32; indptr: (n+1,) int64, nondecreasing, from 0 to
    m; ``cuts``: ``k2_tile_cuts(indptr, m)``, computed here when not
    given.  Returns (n,) int32 (the sum mod 2**32 as two's complement).
    """
    if _on_cpu(contrib, indptr):
        return k2_reduce_plain(contrib, indptr)
    out = _reduce_out(contrib, indptr)
    if out.numel():
        _launch_k2("k2_reduce", contrib, indptr, cuts, out)
    return out


def k2_reduce_min(contrib: torch.Tensor, indptr: torch.Tensor, op: str,
                  cuts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-row int32 min: ``y[d] = min(fill, contrib[indptr[d]:indptr[d+1]])``.

    ``op="imin"``: int32 values, fill ``IMAX``.  ``op="min"``: f32 values
    viewed as int32, fill ``INF_BITS``; the values must be nonnegative, so
    that integer order of the bits is IEEE order.  contrib: (m,) int32;
    indptr and cuts as for :func:`k2_reduce`.  Returns (n,) int32; empty
    rows hold the fill.
    """
    if op not in MIN_FILL:
        raise ValueError(f"op must be min|imin, got {op!r}")
    if _on_cpu(contrib, indptr):
        return k2_reduce_min_plain(contrib, indptr, op)
    out = _reduce_out(contrib, indptr)
    if out.numel():
        _launch_k2("k2_reduce_min", contrib, indptr, cuts, out, MIN_FILL[op])
    return out


def jacobi_blocks(n: int) -> int:
    """The grid of the Jacobi tail kernels for n nodes: a block for each
    ``JACOBI_THREADS`` vectors of four nodes, at most
    ``JACOBI_MAX_BLOCKS``.  A function of n alone, and so is the order in
    which :func:`jacobi_update` adds the residual."""
    return max(1, min(-(-n // (4 * JACOBI_THREADS)), JACOBI_MAX_BLOCKS))


def jacobi_work(n: int, device) -> torch.Tensor:
    """The zeroed scratch of :func:`jacobi_update` for n nodes: a float64
    sum a block, then the ticket that finds the last block, which sets it
    to 0 again.  One scratch serves one launch at a time."""
    return torch.zeros(jacobi_blocks(n) + 1, dtype=torch.float64,
                       device=device)


def jacobi_quantize_plain(scores: torch.Tensor,
                          inv: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`jacobi_quantize`: ``round(scores * inv *
    2**FIXED_BITS)`` as int32."""
    return torch.round(scores * inv * float(1 << FIXED_BITS)).to(torch.int32)


def jacobi_update_plain(acc: torch.Tensor, scores: torch.Tensor, base: float,
                        d: float, out: Optional[torch.Tensor] = None):
    """Plain version of :func:`jacobi_update`: ``y = acc / 2**FIXED_BITS``
    in f32, ``new = base + d * y`` with one rounding (``fill_`` and
    ``add_(alpha=)``, a fused multiply-add), into ``out`` when given, and
    the residual ``sum(|new - scores|)``.  Returns (new, residual)."""
    y = acc.to(torch.float32) / float(1 << FIXED_BITS)
    new = torch.full_like(y, base) if out is None else out.fill_(base)
    new.add_(y, alpha=d)
    return new, torch.sum(torch.abs(new - scores))


def jacobi_quantize(scores: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """The quanta of a Jacobi iteration's out-scores:
    ``xq[i] = round_half_even(f32(scores[i] * inv[i]) * 2**FIXED_BITS)``.

    scores, inv: (n,) f32 (inv is 1/out-degree, 0 for a node without
    out-edges); every product must stay below 2**(31-FIXED_BITS).  Returns
    (n,) int32, the bits of :func:`jacobi_quantize_plain`.
    """
    if _on_cpu(scores, inv):
        return jacobi_quantize_plain(scores, inv)
    _check("scores", scores, torch.float32, scores.device)
    _check("inv", inv, torch.float32, scores.device)
    n = scores.numel()
    if inv.numel() != n:
        raise ValueError(f"inv has {inv.numel()} nodes, scores {n}")
    xq = torch.empty(n, dtype=torch.int32, device=scores.device)
    if n:
        _launch("jacobi_quantize", scores.device, scores.data_ptr(),
                inv.data_ptr(), xq.data_ptr(), n, jacobi_blocks(n))
    return xq


def jacobi_update(acc: torch.Tensor, scores: torch.Tensor, base: float,
                  d: float, out: Optional[torch.Tensor] = None,
                  err: Optional[torch.Tensor] = None,
                  work: Optional[torch.Tensor] = None):
    """A Jacobi iteration's new scores from K2's sums, and its residual:
    ``new[i] = base + d * f32(acc[i]) * 2**-FIXED_BITS`` with one rounding,
    ``err = sum(|new[i] - scores[i]|)``.

    acc: (n,) int32, K2's row sums; scores: (n,) f32, the iteration's old
    scores; base, d: f32 values.  ``out`` ((n,) f32) and ``err`` (a
    one-element f32 tensor) receive the results when given; ``work`` is a
    :func:`jacobi_work` for n, made here when not given.  Returns (new,
    err): ``new`` has the bits of :func:`jacobi_update_plain`; on the card
    ``err`` is summed in float64 in a fixed order (:func:`jacobi_blocks`)
    and rounded to f32 once, so it has the same bits on every run and
    differs from the plain version's f32 sum in the last places.
    """
    if _on_cpu(acc, scores):
        new, e = jacobi_update_plain(acc, scores, base, d, out)
        return new, e if err is None else err.copy_(e)
    device = acc.device
    _check("acc", acc, torch.int32, device)
    _check("scores", scores, torch.float32, device)
    n = acc.numel()
    if scores.numel() != n:
        raise ValueError(f"scores has {scores.numel()} nodes, acc {n}")
    if out is None:
        out = torch.empty(n, dtype=torch.float32, device=device)
    _check("out", out, torch.float32, device)
    if out.numel() != n:
        raise ValueError(f"out has {out.numel()} nodes, acc {n}")
    if err is None:
        err = torch.empty((), dtype=torch.float32, device=device)
    if err.device != device or err.dtype != torch.float32 \
            or err.numel() != 1:
        raise ValueError(f"err must be one f32 on {device}, got "
                         f"{tuple(err.shape)} {err.dtype} on {err.device}")
    if not n:
        return out, err.zero_()
    blocks = jacobi_blocks(n)
    if work is None:
        work = jacobi_work(n, device)
    _check("work", work, torch.float64, device)
    if work.numel() != blocks + 1:
        raise ValueError(f"work has {work.numel()} entries, n={n} takes "
                         f"{blocks + 1}")
    _launch("jacobi_update", device, acc.data_ptr(), scores.data_ptr(),
            out.data_ptr(), n, base, d, work.data_ptr(), err.data_ptr(),
            blocks)
    return out, err


def tc_schedule(offsets: torch.Tensor):
    """The heads :func:`tc_count` counts, by class, from the forward CSR's
    ``offsets``: (long_heads, short_heads), int32 and ascending, the heads
    with more than ``TC_LONG`` forward edges and those with 2 to
    ``TC_LONG`` (a head with fewer closes no wedge)."""
    deg = torch.diff(offsets)
    long_heads = torch.nonzero(deg > TC_LONG)[:, 0].to(torch.int32)
    short_heads = torch.nonzero((deg >= 2) & (deg <= TC_LONG))[:, 0].to(
        torch.int32)
    return long_heads, short_heads


def tc_count_plain(offsets: torch.Tensor, targets: torch.Tensor, h0: int,
                   h1: int) -> torch.Tensor:
    """Plain version of :func:`tc_count`: the wedges of the heads in
    [h0, h1), packed into degree-class chunk matrices and emitted, each
    looked up among the keys of all forward edges by ``torch.searchsorted``
    (:mod:`graph_tpu_torch.engine.tc_join`).  Returns a 0-dim int64 tensor
    on the inputs' device."""
    n = offsets.numel() - 1
    device = targets.device
    heads = torch.repeat_interleave(torch.arange(n, device=device),
                                    torch.diff(offsets))
    lo, hi = int(offsets[h0]), int(offsets[h1])
    mats, cross, _ = tc_join._pack_chunks(heads[lo:hi], targets[lo:hi], n)
    count = tc_join._run_join(mats, cross, heads, targets, device=device)
    return torch.tensor(count, dtype=torch.int64, device=device)


def tc_count(offsets: torch.Tensor, targets: torch.Tensor,
             long_heads: torch.Tensor, short_heads: torch.Tensor,
             h0: int = 0, h1: Optional[int] = None) -> torch.Tensor:
    """Triangles of a graph oriented by rank, over the heads in [h0, h1):
    the sum over those heads u and over i < j of
    ``[N+(u)[j] in N+(N+(u)[i])]``, where N+(u) =
    ``targets[offsets[u]:offsets[u+1]]``.

    offsets: (n+1,) int64 from 0; targets: int32 ids below n, each list
    sorted and above its head; ``long_heads``, ``short_heads``:
    :func:`tc_schedule` of ``offsets``, the heads the kernel counts (the
    plain version counts every head in the range; a head in either class
    gives the same count, only the time differs).  Returns a 0-dim int64
    tensor on the inputs' device; on the card the count is exact, added by
    integer atomics, the same on every run.
    """
    n = offsets.numel() - 1
    h0, h1 = int(h0), n if h1 is None else int(h1)
    if not 0 <= h0 <= h1 <= n:
        raise ValueError(f"head range [{h0}, {h1}) must lie in [0, {n}]")
    if _on_cpu(offsets, targets, long_heads, short_heads):
        return tc_count_plain(offsets, targets, h0, h1)
    device = offsets.device
    _check("offsets", offsets, torch.int64, device)
    _check("targets", targets, torch.int32, device)
    _check("long_heads", long_heads, torch.int32, device)
    _check("short_heads", short_heads, torch.int32, device)
    out = torch.zeros(3, dtype=torch.int64, device=device)
    _launch("tc_count", device, offsets.data_ptr(), targets.data_ptr(),
            long_heads.data_ptr(), long_heads.numel(),
            short_heads.data_ptr(), short_heads.numel(), h0, h1,
            out.data_ptr())
    return out[0]


@dataclasses.dataclass(frozen=True)
class NearFar:
    """The resident state of delta-stepping's near-far settle steps, which
    :func:`sssp_frontier_reset`, :func:`sssp_frontier_relax` and
    :func:`sssp_frontier_advance` read and write in place.

    ``offsets`` (n+1,) int64, ``targets`` (m,) int32 and ``weights`` (m,)
    f32 are the out-CSR.  ``dist`` (n,) f32 holds the distances
    (f32::MAX unreached).  ``marks`` (2, n) int32: each node's stamp (the
    step whose near queue holds it) and far mark (1 while it is in a far
    pile).  ``queues`` (8, n) int32: for near queues 0 and 1 the nodes
    (rows 0-1), their first arcs (rows 2-3) and their first arcs' places
    among the queue's arcs (rows 4-5), these two as uint32 bits, then far
    piles 0 and 1 (rows 6-7).  ``tiles`` (2, m / NEAR_FAR_TILE + 1) int32: for each tile
    of a near queue's arcs, the entry of its first arc.  ``ctrl`` (16,)
    int64: the words named by :data:`HEAD` to :data:`TICKET`.  ``flags``
    (2,) int32: the settle loop's flag (the near queue is not empty) and
    the bucket loop's (a bucket is left).  One run at a time holds
    ``lock``.
    """

    offsets: torch.Tensor
    targets: torch.Tensor
    weights: torch.Tensor
    dist: torch.Tensor
    marks: torch.Tensor
    queues: torch.Tensor
    tiles: torch.Tensor
    ctrl: torch.Tensor
    flags: torch.Tensor
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    @property
    def n(self) -> int:
        return self.dist.numel()


def near_far_state(offsets: torch.Tensor, targets: torch.Tensor,
                   weights: torch.Tensor) -> NearFar:
    """A :class:`NearFar` over the out-CSR (offsets from 0, targets below
    n, weights >= 0), on its device; offsets become int64, targets int32
    and weights f32 where they are not already."""
    n = offsets.numel() - 1
    m = targets.numel()
    if m >= NEAR_FAR_MAX_ARCS:
        raise ValueError(f"the near-far queues count arcs in 32 bits: a "
                         f"graph of {m} arcs needs fewer than "
                         f"{NEAR_FAR_MAX_ARCS}")
    if n >= 1 << 31:
        raise ValueError(f"the near-far queues hold int32 node ids: n={n}")
    device = offsets.device
    i32 = dict(dtype=torch.int32, device=device)
    return NearFar(
        offsets=offsets.to(torch.int64).contiguous(),
        targets=targets.to(torch.int32).contiguous(),
        weights=weights.to(torch.float32).contiguous(),
        dist=torch.empty(n, dtype=torch.float32, device=device),
        marks=torch.empty((2, n), **i32),
        queues=torch.empty((8, n), **i32),
        tiles=torch.empty((2, m // NEAR_FAR_TILE + 1), **i32),
        ctrl=torch.zeros(16, dtype=torch.int64, device=device),
        flags=torch.zeros(2, **i32))


def _launch_near_far(name: str, st: NearFar, settle, more, source: int = 0,
                     delta: float = 1.0) -> None:
    for field, dtype in (("offsets", torch.int64), ("targets", torch.int32),
                         ("weights", torch.float32),
                         ("dist", torch.float32)):
        _check(field, getattr(st, field), dtype, st.dist.device)
    _launch(name, st.dist.device, st.offsets.data_ptr(),
            st.targets.data_ptr(), st.weights.data_ptr(), st.dist.data_ptr(),
            st.marks.data_ptr(), st.queues.data_ptr(), st.tiles.data_ptr(),
            st.ctrl.data_ptr(), settle.data_ptr(),
            None if more is None else more.data_ptr(), st.n,
            st.tiles.shape[1], int(source), float(delta))


def bucket_of(dist: torch.Tensor, delta: float) -> torch.Tensor:
    """floor(dist / delta) as int32 through an f32 division, clamped to
    :data:`BIN_CLAMP` before the cast; f32::MAX is :data:`IMAX` (no
    bucket: an unreached node's, an empty far pile's least): the
    bucket of a distance in every delta-stepping schedule (the kernels'
    ``bucket_of``)."""
    q = torch.clamp(dist / delta, max=BIN_CLAMP)
    return torch.where(dist < F32_MAX, q.to(torch.int32), IMAX)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values below 2**32 as the int32 bits of their uint32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _near_append_plain(st: NearFar, q: int, nodes: torch.Tensor) -> None:
    """Append ``nodes`` (int64, each with out-arcs) to near queue q: their
    entries, first arcs and arc places after the queue's, the tiles whose
    first arc falls among their arcs, and the queue's head."""
    head = int(st.ctrl[HEAD + q])
    count, arcs = head >> 32, head & 0xFFFFFFFF
    k = nodes.numel()
    if not k:
        return
    beg = st.offsets[nodes]
    deg = st.offsets[nodes + 1] - beg
    ends = arcs + torch.cumsum(deg, 0)
    offs = ends - deg
    rows = slice(count, count + k)
    st.queues[q, rows] = nodes.to(torch.int32)
    st.queues[2 + q, rows] = _u32(beg)
    st.queues[4 + q, rows] = _u32(offs)
    total = int(ends[-1])
    first = -(-arcs // NEAR_FAR_TILE)
    starts = torch.arange(first, -(-total // NEAR_FAR_TILE)) * NEAR_FAR_TILE
    st.tiles[q, first:first + starts.numel()] = (
        count + torch.searchsorted(offs, starts, right=True) - 1).to(
            torch.int32)
    st.ctrl[HEAD + q] = ((count + k) << 32) | total


def sssp_frontier_reset_plain(st: NearFar, source: int) -> None:
    """Plain version of :func:`sssp_frontier_reset`."""
    st.dist.fill_(F32_MAX)
    st.dist[source] = 0.0
    st.marks[0].fill_(-1)
    st.marks[1].zero_()
    st.ctrl.zero_()
    st.ctrl[FAR_MIN:FAR_MIN + 2] = IMAX
    if int(st.offsets[source + 1] - st.offsets[source]):
        _near_append_plain(st, 0, torch.tensor([source]))
    st.flags.fill_(1)


def sssp_frontier_relax_plain(st: NearFar, delta: float,
                              settle: torch.Tensor) -> None:
    """Plain version of :func:`sssp_frontier_relax`, in one of the orders
    the kernel's threads may meet in: every candidate ``dist[v] + w`` of the
    step read first, then the least candidate of each target applied."""
    c = st.ctrl
    cur, step, b, fc = (int(c[k]) for k in (CUR, STEP, BUCKET, FC))
    nxt = cur ^ 1
    head = int(c[HEAD + cur])
    count, arcs = head >> 32, head & 0xFFFFFFFF
    nodes = st.queues[cur, :count].long()
    beg = st.queues[2 + cur, :count].long() & 0xFFFFFFFF
    off = st.queues[4 + cur, :count].long() & 0xFFFFFFFF
    deg = torch.diff(torch.cat([off, torch.tensor([arcs])]))
    a = (torch.repeat_interleave(beg - off, deg)
         + torch.arange(arcs, dtype=torch.int64))
    t = st.targets[a].long()
    cand = st.dist[torch.repeat_interleave(nodes, deg)] + st.weights[a]
    t, inv = torch.unique(t, return_inverse=True)
    best = torch.full((t.numel(),), F32_MAX).scatter_reduce(
        0, inv, cand, "amin")
    low = best < st.dist[t]
    t, best = t[low], best[low]
    st.dist[t] = best
    has_arcs = st.offsets[t + 1] > st.offsets[t]
    t, best = t[has_arcs], best[has_arcs]
    tb = bucket_of(best, delta)
    near = tb <= b
    st.marks[0, t[near]] = step + 1
    _near_append_plain(st, nxt, t[near])
    far, far_b = t[~near], tb[~near]
    if far.numel():
        c[FAR_MIN + fc] = min(int(c[FAR_MIN + fc]), int(far_b.min()))
        new = far[st.marks[1, far] == 0]
        st.marks[1, new] = 1
        k = int(c[FAR_COUNT + fc])
        st.queues[6 + fc, k:k + new.numel()] = new.to(torch.int32)
        c[FAR_COUNT + fc] = k + new.numel()
    c[HEAD + cur] = 0
    c[CUR] = nxt
    c[STEP] = step + 1
    c[RELAXED] += arcs
    settle.fill_(int(c[HEAD + nxt]) >> 32 != 0)


def sssp_frontier_advance_plain(st: NearFar, delta: float,
                                settle: torch.Tensor,
                                more: torch.Tensor) -> None:
    """Plain version of :func:`sssp_frontier_advance`."""
    c = st.ctrl
    fc, cur = int(c[FC]), int(c[CUR])
    nf = fc ^ 1
    nxt_bin, count = int(c[FAR_MIN + fc]), int(c[FAR_COUNT + fc])
    v = st.queues[6 + fc, :count].long()
    bb = bucket_of(st.dist[v], delta)
    keep = bb > nxt_bin
    st.marks[1, v[~keep]] = 0
    _near_append_plain(st, cur, v[bb == nxt_bin])
    kept = v[keep]
    if kept.numel():
        k = int(c[FAR_COUNT + nf])
        st.queues[6 + nf, k:k + kept.numel()] = kept.to(torch.int32)
        c[FAR_COUNT + nf] = k + kept.numel()
        c[FAR_MIN + nf] = min(int(c[FAR_MIN + nf]), int(bb[keep].min()))
    c[FAR_COUNT + fc] = 0
    c[FAR_MIN + fc] = IMAX
    c[FC] = nf
    if nxt_bin != IMAX:
        c[BUCKET] = nxt_bin
    settle.fill_(int(c[HEAD + cur]) >> 32 != 0)
    more.fill_(nxt_bin != IMAX)


def sssp_frontier_reset(st: NearFar, source: int) -> None:
    """Start a run from ``source``: every distance f32::MAX but the
    source's 0, stamps and far marks cleared, the source alone in near
    queue 0 (if it has out-arcs), both flags 1."""
    if _on_cpu(st.dist):
        return sssp_frontier_reset_plain(st, source)
    _launch_near_far("sssp_frontier_reset", st, st.flags[0], st.flags[1],
                     source=source)


def sssp_frontier_relax(st: NearFar, delta: float,
                        settle: torch.Tensor) -> None:
    """One settle step: relax every out-arc of the nodes in the current
    near queue; append each target it lowers (and that has out-arcs) to
    the next near queue if its new distance lies in the current bucket
    (``floor(d / delta)`` in f32), else to the far pile; swap the queues,
    add the step's arcs to ``ctrl[RELAXED]`` and set ``settle`` (one
    int32) to whether the next near queue holds a node.  On the card the
    distances are lowered by atomics, so which step lowers which node
    first may differ from run to run; the distances a run ends with do
    not."""
    if _on_cpu(st.dist):
        return sssp_frontier_relax_plain(st, delta, settle)
    _launch_near_far("sssp_frontier_relax", st, settle, None, delta=delta)


def sssp_frontier_advance(st: NearFar, delta: float, settle: torch.Tensor,
                          more: torch.Tensor) -> None:
    """The next bucket: move the far pile's entries of its least bucket
    into the (empty) near queue, drop the entries settled in an earlier
    bucket, keep the rest; set ``settle`` to whether the near queue holds
    a node and ``more`` to whether a bucket was found."""
    if _on_cpu(st.dist):
        return sssp_frontier_advance_plain(st, delta, settle, more)
    _launch_near_far("sssp_frontier_advance", st, settle, more, delta=delta)
