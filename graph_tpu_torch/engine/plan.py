"""EdgePlan — the edge list compiled once into what K1 and K2 read.

Counterpart of ``graph_tpu.engine.plan``, with a layout chosen for
Hopper rather than carried over.  The JAX plan pads slots into windows,
lanemap tables, pair/quad slots and Benes-routed sections because Mosaic
has no vector gather or scatter; a GPU gathers and reads rows directly,
so the port's plan is a destination-sorted CSR of sources:

* slots sorted by (internal destination, internal source);
* ``indptr`` (n+1,) int64: the slots of destination d are
  ``indptr[d]:indptr[d+1]``;
* ``slot_src`` (m,) int32: each slot's internal source;
* ``slot_w`` (m,) f32 or None: each slot's edge value, for plans built
  with ``values=`` (weights follow their edges through the sort, so
  duplicate edges keep their own weights).

``relabel="degree"`` numbers nodes by descending out-degree, ties by id,
exactly as the JAX plan does (``perm`` maps original id -> internal id),
so hot sources sit together in the gathered vector.

A rectangular plan (``n_src=``) has ``n`` destination rows and gathers
from ``n_src`` sources: the out-of-core engine's destination slabs, each
reducing into its own rows from every node.  It is on node ids (no
relabel).

The build runs on the plan's device: the relabel, the (dst, src) sort and
the row offsets are torch operations there.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
from typing import Optional

import numpy as np
import torch

from graph_tpu_torch import profile
from graph_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

FORMAT_VERSION = 3  # v2: slot_w (edge values); v3: n_src
#: The environment variable naming the plan cache directory.
PLAN_CACHE_ENV = "GRAPH_TPU_TORCH_PLAN_CACHE"


@dataclasses.dataclass(frozen=True)
class EdgePlan:
    """Destination-sorted slots of a graph, resident on one device."""

    n: int
    m: int
    indptr: torch.Tensor    # (n+1,) int64 row offsets, internal dst order
    slot_src: torch.Tensor  # (m,) int32 internal source of each slot
    #: (n,) int32 original id -> internal id, or None without relabel
    perm: Optional[torch.Tensor] = None
    #: (m,) f32 edge value of each slot, or None for a plan without values
    slot_w: Optional[torch.Tensor] = None
    #: sources of a rectangular plan; 0 means square (``n`` sources)
    n_src: int = 0

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @property
    def nx(self) -> int:
        """Length of the gathered vector: ``n_src``, or ``n`` if square."""
        return self.n_src or self.n

    def save(self, path: str) -> None:
        """Snapshot the plan as npz with a header (n, m, format version,
        whether it has edge values, n_src)."""
        np.savez(
            path,
            __header__=np.array([self.n, self.m, FORMAT_VERSION,
                                 self.slot_w is not None, self.n_src],
                                np.int64),
            indptr=self.indptr.cpu().numpy(),
            slot_src=self.slot_src.cpu().numpy(),
            perm=(np.zeros(0, np.int32) if self.perm is None
                  else self.perm.cpu().numpy()),
            slot_w=(np.zeros(0, np.float32) if self.slot_w is None
                    else self.slot_w.cpu().numpy()),
        )

    @staticmethod
    def load(path: str, device=None) -> "EdgePlan":
        """Read a snapshot written by :meth:`save` onto ``device``; a
        format-2 snapshot (no ``n_src``) loads as square."""
        device = resolve_device(device)
        with np.load(path) as z:
            h = z["__header__"]
            version = int(h[2]) if h.size >= 3 else -1
            if (version, h.size) not in ((2, 4), (FORMAT_VERSION, 5)):
                raise ValueError(
                    f"{path}: plan format {version} != {FORMAT_VERSION}; "
                    "rebuild the plan")
            n, m, has_w = int(h[0]), int(h[1]), bool(h[3])
            n_src = int(h[4]) if version == FORMAT_VERSION else 0
            indptr = torch.from_numpy(z["indptr"]).to(device)
            slot_src = torch.from_numpy(z["slot_src"]).to(device)
            perm = z["perm"]
            slot_w = z["slot_w"]
        if indptr.shape != (n + 1,) or slot_src.shape != (m,) or (
                perm.size and perm.shape != (n,)) or (
                has_w and (slot_w.shape != (m,)
                           or slot_w.dtype != np.float32)):
            raise ValueError(f"{path}: array shapes disagree with the header")
        return EdgePlan(n=n, m=m, indptr=indptr, slot_src=slot_src,
                        perm=torch.from_numpy(perm).to(device)
                        if perm.size else None,
                        slot_w=torch.from_numpy(slot_w).to(device)
                        if has_w else None, n_src=n_src)


def _as_ids(a, device: torch.device) -> torch.Tensor:
    """Edge endpoints as an int64 tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)


def _as_values(values, device: torch.device) -> Optional[torch.Tensor]:
    """Edge values as an f32 tensor on ``device`` (None stays None)."""
    if values is None:
        return None
    if isinstance(values, torch.Tensor):
        return values.to(device=device, dtype=torch.float32)
    return torch.from_numpy(
        np.ascontiguousarray(values, dtype=np.float32)).to(device)


def _compile(src: torch.Tensor, dst: torch.Tensor, n: int,
             perm: Optional[torch.Tensor],
             values: Optional[torch.Tensor], n_src: int = 0) -> EdgePlan:
    m = src.numel()
    nx = n_src or n
    if dst.numel() != m:
        raise ValueError(f"src has {m} edges, dst {dst.numel()}")
    if values is not None and values.numel() != m:
        raise ValueError(f"values has {values.numel()} entries, src {m}")
    if m and (int(torch.minimum(src.min(), dst.min())) < 0
              or int(src.max()) >= nx or int(dst.max()) >= n):
        raise ValueError(f"edge endpoints must lie in [0, {nx}) for "
                         f"sources and [0, {n}) for destinations")
    if perm is not None:
        p = perm.long()
        src, dst = p[src], p[dst]
    # one int64 key orders slots by (dst, src); n, nx < 2**31 keep it
    # exact.  Weights follow their slots: the sort's indices gather them,
    # so duplicate edges keep their own (stable: the same plan every build).
    slot_w = None
    if values is None:
        key = torch.sort(dst * nx + src).values
    else:
        key, order = torch.sort(dst * nx + src, stable=True)
        slot_w = values[order]
    slot_src = (key % max(nx, 1)).to(torch.int32)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    torch.cumsum(torch.bincount(dst, minlength=n), 0, out=indptr[1:])
    return EdgePlan(n=n, m=m, indptr=indptr, slot_src=slot_src, perm=perm,
                    slot_w=slot_w, n_src=n_src)


def degree_perm(src: torch.Tensor, n: int) -> torch.Tensor:
    """original id -> internal id by descending out-degree, ties by id.

    The same permutation as the JAX plan's ``np.argsort(-deg,
    kind="stable")`` relabel."""
    deg = torch.bincount(src, minlength=n)
    order = torch.sort(-deg, stable=True).indices
    perm = torch.empty(n, dtype=torch.int32, device=src.device)
    perm[order] = torch.arange(n, dtype=torch.int32, device=src.device)
    return perm


def build_plan(src, dst, n: int, relabel: Optional[str] = None,
               device=None, values=None,
               n_src: Optional[int] = None) -> EdgePlan:
    """Compile an edge list (numpy arrays or tensors) into an EdgePlan.

    The plan gathers x[src] and reduces into y[dst].  ``relabel="degree"``
    builds it on the internal descending-out-degree node order.
    ``values`` (m,) are the edge values (weights), stored as f32 per slot.
    ``n_src`` makes the plan rectangular: ``n`` destination rows gathering
    from ``n_src`` sources (exclusive with ``relabel``).
    """
    if relabel not in (None, "degree"):
        raise ValueError(f"relabel must be None or 'degree', got {relabel!r}")
    if n_src is not None and relabel is not None:
        raise ValueError("relabel and n_src (rectangular plan) are exclusive")
    device = resolve_device(device)
    n, n_src = int(n), int(n_src or 0)
    if max(n, n_src) >= 2**31:
        raise OverflowError(f"n = {n}, n_src = {n_src} do not fit the "
                            "plan's int32 sources")
    src_t, dst_t = _as_ids(src, device), _as_ids(dst, device)
    perm = degree_perm(src_t, n) if relabel == "degree" else None
    return _compile(src_t, dst_t, n, perm, _as_values(values, device), n_src)


def plan_from_numpy(src: np.ndarray, dst: np.ndarray, n: int,
                    perm: Optional[np.ndarray] = None,
                    device=None, values=None) -> EdgePlan:
    """Compile numpy edge arrays (and values) with a given node order.

    ``perm`` (original id -> internal id), when given, is used as the
    plan's internal order; it may come from a ``graph_tpu`` EdgePlan, so
    that both packages run on the same internal order.
    """
    device = resolve_device(device)
    n = int(n)
    if n >= 2**31:
        raise OverflowError(f"n = {n} does not fit the plan's int32 sources")
    perm_t = None
    if perm is not None:
        perm = np.asarray(perm)
        if perm.shape != (n,) or not np.array_equal(
                np.sort(perm), np.arange(n)):
            raise ValueError("perm must be a permutation of range(n)")
        perm_t = torch.from_numpy(perm.astype(np.int32)).to(device)
    return _compile(_as_ids(src, device), _as_ids(dst, device), n, perm_t,
                    _as_values(values, device))


def _host(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.ascontiguousarray(a, dtype=dtype)


def plan_cache_path(cache_dir: str, src, dst, n: int,
                    relabel: Optional[str] = None, values=None) -> str:
    """Content-addressed cache filename for a plan.

    Keyed on the exact edge arrays (as int64), the edge values (as f32),
    the node count, the relabel and the plan format version: a graph
    rebuilt from the same inputs reuses its plan across processes, and a
    changed weight misses.
    """
    src, dst = _host(src, np.int64), _host(dst, np.int64)
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray([n, src.size, FORMAT_VERSION, values is not None],
                        np.int64).tobytes())
    h.update((relabel or "").encode() + b"\0")
    h.update(src.tobytes())
    h.update(dst.tobytes())
    if values is not None:
        h.update(_host(values, np.float32).tobytes())
    return os.path.join(cache_dir, f"torchplan-{h.hexdigest()}.npz")


def load_or_build_plan(src, dst, n: int, cache_dir: Optional[str] = None,
                       relabel: Optional[str] = None,
                       device=None, values=None) -> EdgePlan:
    """:func:`build_plan` with cross-process persistence.

    ``cache_dir`` (or $GRAPH_TPU_TORCH_PLAN_CACHE) holds content-addressed
    plan snapshots; a hit skips the build.  Without either, it builds.
    What the cache did (``hit``, ``miss`` or ``off``) is the counter
    ``plan_cache`` of the innermost open span
    (:func:`graph_tpu_torch.profile.count`).
    """
    if cache_dir is None:
        cache_dir = os.environ.get(PLAN_CACHE_ENV)
    if not cache_dir:
        profile.count(plan_cache="off")
        return build_plan(src, dst, n, relabel=relabel, device=device,
                          values=values)
    os.makedirs(cache_dir, exist_ok=True)
    path = plan_cache_path(cache_dir, src, dst, n, relabel=relabel,
                           values=values)
    if os.path.exists(path):
        try:
            plan = EdgePlan.load(path, device=device)
            logger.info("EdgePlan cache hit: %s", path)
            profile.count(plan_cache="hit")
            return plan
        except (OSError, ValueError, KeyError) as exc:
            logger.warning("EdgePlan cache %s unreadable (%s)", path, exc)
    plan = build_plan(src, dst, n, relabel=relabel, device=device,
                      values=values)
    profile.count(plan_cache="miss")
    try:
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        plan.save(tmp)
        os.replace(tmp, path)
        logger.info("EdgePlan cached: %s", path)
    except OSError as exc:  # read-only cache dir etc.
        logger.warning("EdgePlan cache write failed (%s)", exc)
    return plan
