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

Sums are int32 fixed point, ``round(x * 2**FIXED_BITS)``; integer
addition and min do not depend on order, so every reduction order gives
the same bits as the JAX package.

Each wrapper runs its plain PyTorch version for tensors on the CPU.  For
CUDA tensors it checks device, dtype, shape and contiguity, launches its
kernel on the current stream (building it at first use) and raises if
the launch reports an error.  It never falls back to the plain version
on the card.  ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import torch

from graph_tpu_torch.engine import _build

FIXED_BITS = 30  # fixed-point fraction bits
INF = 3.0e38  # the min paths' +inf stand-in, as in graph_tpu
INF_BITS = 2137108966  # float32(INF) viewed as int32
IMAX = 2147483647  # int32 max: the "+inf" of the integer-min path
#: The fill of each K2 min op: the value of an empty row.
MIN_FILL = {"imin": IMAX, "min": INF_BITS}

#: Kernel launches since the last :func:`reset_launches`.  A wrapper adds
#: one where it launches its kernel, and nowhere else.
LAUNCHES = {"k1_gather": 0, "k1_gather_weighted": 0, "k2_reduce": 0,
            "k2_reduce_min": 0}


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


def k1_gather(xq: torch.Tensor, slot_src: torch.Tensor) -> torch.Tensor:
    """Per-slot gather: ``out[i] = xq[slot_src[i]]``.

    xq: (n_src,) int32 (quanta, labels, or f32 values viewed as int32);
    slot_src: (m,) int32 indices into xq, as a plan stores them (the plan
    checks their range when it is built).  Returns (m,) int32.
    """
    if _on_cpu(xq, slot_src):
        return k1_gather_plain(xq, slot_src)
    _check("xq", xq, torch.int32, xq.device)
    _check("slot_src", slot_src, torch.int32, xq.device)
    out = torch.empty_like(slot_src)
    if out.numel():
        _launch("k1_gather", xq.device, xq.data_ptr(), slot_src.data_ptr(),
                out.data_ptr(), out.numel())
    return out


def k1_gather_weighted(x: torch.Tensor, slot_src: torch.Tensor,
                       w: torch.Tensor, combine: str,
                       quantize: bool) -> torch.Tensor:
    """Per-slot gather with an edge weight, in f32:
    ``v[i] = x[slot_src[i]] + w[i]`` (``combine="add"``) or ``* w[i]``
    (``"mul"``).

    x: (n_src,) f32; slot_src: (m,) int32; w: (m,) f32.  Returns (m,) f32
    ``v``, or with ``quantize`` the (m,) int32 quanta
    ``round_half_even(v * 2**FIXED_BITS)`` that :func:`k2_reduce` sums
    (|v| must stay below 2**(31-FIXED_BITS)).
    """
    if combine not in ("add", "mul"):
        raise ValueError(f"combine must be add|mul, got {combine!r}")
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
                out.numel(), int(combine == "mul"), int(bool(quantize)))
    return out


def _reduce_out(contrib: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    _check("contrib", contrib, torch.int32, contrib.device)
    _check("indptr", indptr, torch.int64, contrib.device)
    if indptr.numel() < 1:
        raise ValueError("indptr needs at least one offset")
    return torch.empty(indptr.numel() - 1, dtype=torch.int32,
                       device=contrib.device)


def k2_reduce(contrib: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    """Per-row wraparound sum: ``y[d] = sum(contrib[indptr[d]:indptr[d+1]])``.

    contrib: (m,) int32; indptr: (n+1,) int64, nondecreasing, from 0 to
    m.  Returns (n,) int32 (the sum mod 2**32 as two's complement).
    """
    if _on_cpu(contrib, indptr):
        return k2_reduce_plain(contrib, indptr)
    out = _reduce_out(contrib, indptr)
    if out.numel():
        _launch("k2_reduce", contrib.device, contrib.data_ptr(),
                indptr.data_ptr(), out.data_ptr(), out.numel())
    return out


def k2_reduce_min(contrib: torch.Tensor, indptr: torch.Tensor,
                  op: str) -> torch.Tensor:
    """Per-row int32 min: ``y[d] = min(fill, contrib[indptr[d]:indptr[d+1]])``.

    ``op="imin"``: int32 values, fill ``IMAX``.  ``op="min"``: f32 values
    viewed as int32, fill ``INF_BITS``; the values must be nonnegative, so
    that integer order of the bits is IEEE order.  contrib: (m,) int32;
    indptr as for :func:`k2_reduce`.  Returns (n,) int32; empty rows hold
    the fill.
    """
    if op not in MIN_FILL:
        raise ValueError(f"op must be min|imin, got {op!r}")
    if _on_cpu(contrib, indptr):
        return k2_reduce_min_plain(contrib, indptr, op)
    out = _reduce_out(contrib, indptr)
    if out.numel():
        _launch("k2_reduce_min", contrib.device, contrib.data_ptr(),
                indptr.data_ptr(), out.data_ptr(), out.numel(),
                MIN_FILL[op])
    return out
