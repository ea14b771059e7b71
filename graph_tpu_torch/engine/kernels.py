"""The EdgeEngine's kernels: K1 (gather) and K2 (segment sum).

Counterparts of ``graph_tpu.engine.kernels.k1_gather`` and
``k2_reduce(op="sum")``, written by hand in CUDA C++ for Hopper
(``graph_tpu_torch/csrc/k1_gather.cu`` and ``k2_reduce.cu``).  The plan
(:mod:`graph_tpu_torch.engine.plan`) stores slots sorted by destination
with row offsets, so:

* K1: ``contrib[i] = xq[slot_src[i]]`` for every slot, int32 quanta;
* K2: ``y[d] = sum(contrib[indptr[d]:indptr[d+1]])`` with int32
  wraparound; empty rows give 0.

Sums are int32 fixed point, ``round(x * 2**FIXED_BITS)``; integer
addition does not depend on order, so every reduction order gives the
same bits as the JAX package.

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

#: Kernel launches since the last :func:`reset_launches`.  A wrapper adds
#: one where it launches its kernel, and nowhere else.
LAUNCHES = {"k1_gather": 0, "k2_reduce": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def k1_gather_plain(xq: torch.Tensor, slot_src: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: ``xq[slot_src]``."""
    return xq[slot_src.long()]


def k2_reduce_plain(contrib: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: row sums in int64, wrapped to int32 explicitly."""
    csum = torch.zeros(contrib.numel() + 1, dtype=torch.int64,
                       device=contrib.device)
    torch.cumsum(contrib.to(torch.int64), 0, out=csum[1:])
    acc = csum[indptr[1:]] - csum[indptr[:-1]]
    return (((acc + 2**31) % 2**32) - 2**31).to(torch.int32)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor, "
                         f"got shape {tuple(t.shape)}")


def _launch(name: str, device: torch.device, *args) -> None:
    fn = getattr(_build.load(name), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def k1_gather(xq: torch.Tensor, slot_src: torch.Tensor) -> torch.Tensor:
    """Per-slot gather: ``out[i] = xq[slot_src[i]]``.

    xq: (n_src,) int32 quanta; slot_src: (m,) int32 indices into xq, as
    a plan stores them (the plan checks their range when it is built).
    Returns (m,) int32.
    """
    if xq.device.type == "cpu" and slot_src.device.type == "cpu":
        return k1_gather_plain(xq, slot_src)
    _check("xq", xq, torch.int32, xq.device)
    _check("slot_src", slot_src, torch.int32, xq.device)
    out = torch.empty_like(slot_src)
    if out.numel():
        _launch("k1_gather", xq.device, xq.data_ptr(), slot_src.data_ptr(),
                out.data_ptr(), out.numel())
    return out


def k2_reduce(contrib: torch.Tensor, indptr: torch.Tensor) -> torch.Tensor:
    """Per-row wraparound sum: ``y[d] = sum(contrib[indptr[d]:indptr[d+1]])``.

    contrib: (m,) int32; indptr: (n+1,) int64, nondecreasing, from 0 to
    m.  Returns (n,) int32 (the sum mod 2**32 as two's complement).
    """
    if contrib.device.type == "cpu" and indptr.device.type == "cpu":
        return k2_reduce_plain(contrib, indptr)
    _check("contrib", contrib, torch.int32, contrib.device)
    _check("indptr", indptr, torch.int64, contrib.device)
    if indptr.numel() < 1:
        raise ValueError("indptr needs at least one offset")
    out = torch.empty(indptr.numel() - 1, dtype=torch.int32,
                      device=contrib.device)
    if out.numel():
        _launch("k2_reduce", contrib.device, contrib.data_ptr(),
                indptr.data_ptr(), out.data_ptr(), out.numel())
    return out
