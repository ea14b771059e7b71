"""Where the port's entry points run.

Every entry point takes ``device``.  Given, it is used as is; not given,
the entry point runs on the card, and raises when there is none.  The
port never moves to the CPU on its own: a CPU run is asked for, as the
tests do with ``device="cpu"``.  Algorithms run where their graph lies,
unless the caller names another device or the graph is host-resident
(:func:`run_device`).
"""

from __future__ import annotations

import numpy as np
import torch

from graph_tpu_torch import profile


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; the card when ``device`` is None."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "graph_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def run_device(graph, device=None) -> torch.device:
    """Where an algorithm runs on ``graph``: ``device`` when given, else
    the graph's own device.  A host-resident graph (``graph.host``) has
    none: it runs on the card, and raises without one, like any entry
    point given no device."""
    if device is not None:
        return torch.device(device)
    if getattr(graph, "host", False):
        return resolve_device(None)
    return graph.device


def concrete_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with the index its tensors report:
    a bare ``"cuda"`` names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (a host timer's end point)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """An answer copied to a host array: a ``result.to_host`` span
    (:mod:`graph_tpu_torch.profile`) with counter ``bytes``."""
    with profile.span("result.to_host") as sp:
        out = t.cpu().numpy()
        if sp:
            sp.count(bytes=out.nbytes)
    return out
