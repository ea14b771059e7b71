"""What every probe shares: the timer, one measured case, the command line."""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import torch

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.probes import BLK, NBLK

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


def header(prog: str, device: torch.device, nblk: int) -> None:
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    print(f"{prog} on {name}: {nblk} blocks, {nblk * BLK} slots",
          flush=True)
