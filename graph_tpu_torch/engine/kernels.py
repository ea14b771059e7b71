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

Each wrapper runs its plain PyTorch version for tensors on the CPU.  For
CUDA tensors it checks device, dtype, shape and contiguity, launches its
kernel on the current stream (building it at first use) and raises if
the launch reports an error.  It never falls back to the plain version
on the card.  ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

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
            "tc_count": 0}
#: The device function each wrapper launches once a call, as a pattern over
#: mangled kernel names: a captured graph's kernel nodes are counted by it
#: (:mod:`graph_tpu_torch.engine.loop`).
KERNEL_NODES = {"k1_gather": r"k1_gather_kernel",
                "k1_gather_weighted": r"k1_gather_weighted_kernel",
                "k2_reduce": r"k2_tile_kernel.*SumOp",
                "k2_reduce_min": r"k2_tile_kernel.*MinOp",
                "jacobi_quantize": r"jacobi_quantize_kernel",
                "jacobi_update": r"jacobi_update_kernel",
                "tc_count": r"tc_count_kernel"}
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


def _launch(name: str, device: torch.device, *args) -> None:
    fn = _build.load(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[name] += 1
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
