"""What every probe shares: the timer, one measured case, the command line."""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.probes import BLK, NBLK
from graph_tpu_torch.probes import k2_kernels as kk
from graph_tpu_torch.probes.k2_layout import LANES

#: Timed calls a case (the scripts' 40 repetitions).
REPS = 40


def time_ms(fn: Callable[[], object], device: torch.device,
            reps: int = REPS) -> float:
    """Mean ms a call over ``reps`` calls after one warm-up: CUDA events on
    a card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn: Callable[[], object], device: torch.device,
             reps: int = REPS) -> float:
    """Mean ms of ``fn``'s work on the card alone: ``fn`` captured once in
    a CUDA graph, the graph replayed ``reps`` times (the host's time a
    call, which :func:`time_ms` counts when it is the longer, is left
    out).  The capture is one more launch of each kernel; the replays are
    not counted."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, device, reps)


def measure(label: str, kernel: Callable[[], torch.Tensor],
            plain: Callable[[], torch.Tensor], device: torch.device,
            table_elems: int, reps: int = REPS,
            x_idx: Optional[torch.Tensor] = None) -> dict:
    """One case: the kernel against its plain version (``exact``: the same
    bits on every slot), then its time, and with ``x_idx`` the share of
    slots equal to ``x[idx]``.  Prints the case's line and returns it.

    ``bytes`` is what the function must move: 2 B of index in and 4 B out
    a slot, and the table or window once."""
    got = kernel()
    want = plain()
    exact = torch.equal(got.view(torch.int32), want.view(torch.int32))
    slots = got.numel()
    ms = time_ms(kernel, device, reps)
    res = {"label": label, "slots": slots, "ms": ms,
           "ns_per_slot": ms * 1e6 / slots,
           "bytes": 6 * slots + 4 * table_elems, "exact": exact}
    res["gb_per_s"] = res["bytes"] / ms / 1e6
    line = (f"{label}: {ms:9.4f} ms -> {res['ns_per_slot']:.5f} ns/slot "
            f"{res['gb_per_s']:8.1f} GB/s exact={exact}")
    if x_idx is not None:
        res["x_idx_share"] = float((got == x_idx).double().mean())
        line += f" x[idx] share={res['x_idx_share']:.4f}"
    print(line, flush=True)
    return res


def stream_case(label: str, steps, v: torch.Tensor, sides, *, mode: str,
                read: str, device: torch.device, reps: int,
                script_b_per_slot: int, slope: bool = False,
                note: str = "") -> dict:
    """One K2 stream-probe variant through its kernel (``mode="float"``:
    the f32 kernel of ``perf_k2_streams.py``): the kernel against its
    plain version (``exact``: the same bits on every element), then its
    mean time a call over ``reps`` calls and, on a card, the card's own
    time a call (:func:`graph_ms`: ``device_ms``; a call whose host work
    takes longer than the card's is host-bound).  ``slots`` are the
    contribution slots a call streams (over its passes); the script's
    bytes are ``script_b_per_slot`` a slot, the port's the bytes the
    kernel must move.  With ``slope``, also ``4 * reps`` calls and the
    script's slope: the time a call with the fixed cost cancelled
    (``perf_k2_io5.py``).  Prints the case's line, ending with ``note``,
    and returns it."""
    f32 = mode == "float"
    sched = kk.schedule(steps, device, ordered=f32)

    def kernel():
        if f32:
            return kk.sec_stream_f32(v, sides, sched)
        return kk.sec_stream(v, sides, sched, mode, read)

    def plain():
        if f32:
            return kk.sec_stream_f32_plain(v, sides, steps)
        return kk.sec_stream_plain(v, sides, steps, mode, read)

    exact = torch.equal(kernel().view(torch.int32),
                        plain().view(torch.int32))
    slots = v.shape[0] * LANES * steps.passes
    script_bytes = script_b_per_slot * slots
    port_bytes = kk.moved_bytes(steps, sides, read)
    ms = time_ms(kernel, device, reps)
    res = {"label": label, "slots": slots, "reps": reps, "ms": ms,
           "ns_per_slot": ms * 1e6 / slots, "script_bytes": script_bytes,
           "port_bytes": port_bytes,
           "script_gb_per_s": script_bytes / ms / 1e6,
           "port_gb_per_s": port_bytes / ms / 1e6, "exact": exact,
           "kernel": "probe_sec_stream_f32" if f32 else "probe_sec_stream",
           "mode": mode, "read": read, "nsides": len(sides),
           "passes": steps.passes, "steps": steps.nsteps, "h": steps.h,
           "nout": steps.nout}
    line = (f"{label:12s}: {ms:9.4f} ms x{reps} -> "
            f"{res['ns_per_slot']:.5f} ns/slot ("
            f"{script_b_per_slot} B/slot = "
            f"{res['script_gb_per_s']:.0f} GB/s; moved "
            f"{port_bytes / slots:.3f} B/slot = "
            f"{res['port_gb_per_s']:.0f} GB/s)")
    if device.type == "cuda":
        dms = res["device_ms"] = graph_ms(kernel, device, reps)
        res["device_gb_per_s"] = port_bytes / dms / 1e6
        line += f" device {dms:.4f} ms = {res['device_gb_per_s']:.0f} GB/s"
    if slope:
        ms4 = time_ms(kernel, device, 4 * reps)
        t1, t4 = ms * reps, ms4 * 4 * reps
        res["ms_4x"] = ms4
        res["slope_ms"] = (t4 - t1) / (3 * reps)
        res["slope_ns_per_slot"] = res["slope_ms"] * 1e6 / slots
        res["floor_ms"] = t1 - (t4 - t1) / 3
        line += (f" {t1:.2f}/{t4:.2f} ms (x{reps}/x{4 * reps}) -> slope "
                 f"{res['slope_ns_per_slot']:.5f} ns/slot; floor~"
                 f"{res['floor_ms']:.3f} ms")
    if note:
        res["note"] = note
    print(f"{line} exact={exact}{' ' + note if note else ''}", flush=True)
    return res


def card_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))


def parse_args(argv, prog: str, doc: str, windows: bool):
    """``[win ...] [--blocks N] [--device D]``; returns the arguments
    with ``device`` resolved (the card unless asked)."""
    p = argparse.ArgumentParser(prog=prog, description=doc)
    if windows:
        p.add_argument("win", type=int, nargs="*",
                       help="windows (default: the script's)")
    p.add_argument("--blocks", type=int, default=NBLK,
                   help=f"blocks of {BLK} slots (default {NBLK})")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    args.device = resolve_device(args.device)
    return args


def parse_rmat_args(argv, prog: str, doc: str, relabel: bool):
    """The RMAT-layout scripts' ``[scale] [relabel] [--reps N]
    [--device D]``; ``relabel`` is None for ``"none"``."""
    p = argparse.ArgumentParser(prog=prog, description=doc)
    p.add_argument("scale", type=int, nargs="?", default=22)
    if relabel:
        p.add_argument("relabel", nargs="?", default="degree",
                       choices=("degree", "none"))
    p.add_argument("--reps", type=int, default=None,
                   help="calls a case (default: the script's "
                   "max(8, 1.2e9 // slots))")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    args.device = resolve_device(args.device)
    rel = getattr(args, "relabel", "degree")
    args.relabel = None if rel == "none" else rel
    return args


def layout_header(prog: str, device: torch.device, sec_mid, nmid: int,
                  reps: int) -> None:
    nsec = len(sec_mid)
    print(f"{prog} on {card_name(device)}: nsec={nsec} nmid={nmid} "
          f"nslots={nsec * 512 * LANES} reps={reps}", flush=True)


def header(prog: str, device: torch.device, nblk: int) -> None:
    print(f"{prog} on {card_name(device)}: {nblk} blocks, {nblk * BLK} "
          "slots", flush=True)
