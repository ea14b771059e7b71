"""The routed section inputs of the K2 stage probes.

Two kinds:

* the scripts' synthetic streams: ``perf_k2_stages.py``'s f32 ``v`` and
  u16 ``wa``, ``wb``, ``ci`` below 2^14 over 512 sections of 512 rows, 16
  a mid, with its ``meta`` windows (the script's unseeded global
  ``np.random`` is seeded ``default_rng(0)`` here, each stream drawn in its
  final dtype); ``perf_k2_sec128.py``'s ``gen_keys`` sections from
  ``default_rng(7)``, routed at 512 and at 128 rows;
* a stand-in for the TPU plan's routed sections of a graph
  (:func:`stand_in_keys`), built from the port's plan, which routes
  nothing: each mid of 65,536 internal destinations takes its in-edges in
  source order (the order the TPU's K1 emits them); each section of
  65,536 slots holds one lead pad key -1 (as ``graph_tpu/engine/plan.py``
  does), then up to 65,535 edges, then tail pads ``MID``; the sections are
  routed by the native router (:mod:`graph_tpu_torch.native.edge_plan`)
  with ``default_rng(1)`` contributions (``k2_layout.contributions``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from graph_tpu_torch.native.edge_plan import route_sections
from graph_tpu_torch.probes import k2_layout, route as R
from graph_tpu_torch.probes.k2_layout import IO_MID_EVERY, LANES, SEC_R

#: Edges a stand-in section holds beside its lead pad.
EDGES = R.SEC - 1
META_WORDS = 129


# ---- perf_k2_stages.py -----------------------------------------------------

def stages_meta(nsec: int) -> np.ndarray:
    """``perf_k2_stages.py:49-54``: per section ``meta[0]`` the mid's first
    section, 64 window bases ``min(1024 t, 57344)``, 64 sub-block counts
    2; flat (nsec * 129,) int32."""
    meta = np.zeros((nsec, META_WORDS), np.int32)
    meta[:, 0] = (np.arange(nsec) % IO_MID_EVERY == 0)
    meta[:, 1:65] = (np.arange(64) * 1024) // 1
    meta[:, 1:65] = np.minimum(meta[:, 1:65], 65536 - 8192)
    meta[:, 65:129] = 2
    return meta.reshape(-1)


def stages_inputs(nsec: int = 512) -> tuple:
    """(v, wa, wb, ci, sec_mid, meta) as numpy: v uniform f32 in [0, 1),
    the streams u16 below 2^14, ``sec_mid = arange(nsec) // 16``."""
    rng = np.random.default_rng(0)
    shape = (nsec * SEC_R, LANES)
    v = rng.random(shape, dtype=np.float32)
    streams = [rng.integers(0, 1 << 14, shape, dtype=np.uint16)
               for _ in range(3)]
    return (v, *streams, np.arange(nsec, dtype=np.int32) // IO_MID_EVERY,
            stages_meta(nsec))


# ---- the stand-in for a graph's routed sections ----------------------------

@dataclasses.dataclass
class StandIn:
    """The unrouted stand-in: ``keys`` (nsec * 65,536,) int32 on the host,
    ``sec_mid`` (nsec,) int32, ``nmid``, and ``pos`` (m,) int64 on the
    plan's device: where each slot of the plan lies in the layout."""

    keys: np.ndarray
    sec_mid: np.ndarray
    nmid: int
    pos: torch.Tensor

    @property
    def nsec(self) -> int:
        return len(self.sec_mid)


def stand_in_keys(indptr: torch.Tensor, slot_src: torch.Tensor) -> StandIn:
    """The stand-in's section keys from a destination-sorted CSR
    (``indptr`` (n+1,) int64, ``slot_src`` (m,) int32, on any device)."""
    dev = slot_src.device
    n = indptr.numel() - 1
    m = slot_src.numel()
    nmid = max(1, -(-n // R.MID))
    dst = torch.repeat_interleave(torch.arange(n, device=dev),
                                  torch.diff(indptr), output_size=m)
    mid = dst // R.MID
    order = torch.argsort(mid * (1 << 32) + slot_src.to(torch.int64),
                          stable=True)
    cnt = torch.bincount(mid, minlength=nmid)
    per = torch.clamp((cnt + EDGES - 1) // EDGES, min=1)
    sec_base = torch.cumsum(per, 0) - per
    mstart = torch.cumsum(cnt, 0) - cnt
    m_sorted = mid[order]
    p = torch.arange(m, device=dev) - mstart[m_sorted]
    flat = (sec_base[m_sorted] + p // EDGES) * R.SEC + 1 + p % EDGES
    nsec = int(per.sum())
    keys = torch.full((nsec, R.SEC), R.MID, dtype=torch.int32, device=dev)
    keys[:, 0] = -1
    keys.view(-1)[flat] = (dst[order] % R.MID).to(torch.int32)
    pos = torch.empty(m, dtype=torch.int64, device=dev)
    pos[order] = flat
    sec_mid = torch.repeat_interleave(torch.arange(nmid, device=dev), per)
    return StandIn(keys.view(-1).cpu().numpy(),
                   sec_mid.to(torch.int32).cpu().numpy(), nmid, pos)


@dataclasses.dataclass
class RoutedLayout:
    """A routed stand-in on a device: contributions ``v`` (nsec * 512, 128)
    f32, the five u16 streams ``sides`` (wa, wb, sstart, wa2, wb2), the
    layout, each plan slot's position ``pos``, and the routing seconds."""

    v: torch.Tensor
    sides: list
    sec_mid: np.ndarray
    nmid: int
    pos: torch.Tensor
    route_s: float

    @property
    def nsec(self) -> int:
        return len(self.sec_mid)


def route_stand_in(stand_in: StandIn, nthreads: int = 0) -> tuple:
    """Route the stand-in's sections on the host: (the five streams as
    numpy, seconds)."""
    t0 = time.perf_counter()
    streams = route_sections(stand_in.keys, 512, nthreads)
    return streams, time.perf_counter() - t0


def routed_layout(stand_in: StandIn, streams, route_s: float,
                  device) -> RoutedLayout:
    """The stand-in with its routed streams and ``default_rng(1)``
    contributions on ``device``."""
    dev = torch.device(device)
    return RoutedLayout(
        k2_layout.contributions(stand_in.nsec, dev),
        [torch.from_numpy(s).to(dev) for s in streams], stand_in.sec_mid,
        stand_in.nmid, stand_in.pos.to(dev), route_s)


def rmat_layout(scale: int, relabel: Optional[str], device,
                nthreads: int = 0) -> RoutedLayout:
    """The routed stand-in of Graph500 RMAT at ``scale`` (edge factor 16,
    seed 42), planned on ``device`` with ``relabel``."""
    from graph_tpu_torch.engine.plan import build_plan
    from graph_tpu_torch.generate import host_rmat

    src, dst = host_rmat(scale)
    plan = build_plan(src, dst, 1 << scale, relabel=relabel, device=device)
    stand_in = stand_in_keys(plan.indptr, plan.slot_src)
    streams, secs = route_stand_in(stand_in, nthreads)
    return routed_layout(stand_in, streams, secs, device)


def route_steps(sec_mid: np.ndarray, nmid: int) -> k2_layout.Steps:
    """The RMAT scripts' grid (``perf_k2v2_stages.py``,
    ``perf_k2_route_ops.py``, ``k2_128``): step k reads section k into
    block ``sec_mid[k]`` of exactly ``nmid``, zeroed by ``first``."""
    sm = np.asarray(sec_mid, np.int64)
    h = SEC_R
    return k2_layout.Steps(np.arange(len(sm), dtype=np.int64) * h, sm,
                           k2_layout.first_of_mid(sm), h, int(nmid))


def section_steps(nsec: int, rows: int) -> k2_layout.Steps:
    """One section a block, each written once: ``sec_mid = arange``."""
    k = np.arange(nsec, dtype=np.int64)
    return k2_layout.Steps(k * rows, k, np.ones(nsec, np.bool_), rows,
                           max(nsec, 1))


def quanta_in_csr_order(layout: RoutedLayout) -> torch.Tensor:
    """The contributions' quanta ``round(v * 2^30)`` in the plan's slot
    order: what K2 sums where the stand-in's ``full`` routes."""
    v = layout.v.view(-1)[layout.pos]
    return torch.round(v * float(1 << 30)).to(torch.int32)


# ---- perf_k2_sec128.py -----------------------------------------------------

def sec128_inputs(nsec512: int = 8, seed: int = 7) -> dict:
    """``perf_k2_sec128.py``'s ``main`` inputs: ``nsec512`` sections of
    ``gen_keys`` routed at 512 rows (wa, wb, ss, wa2, wb2), four times as
    many at 128 rows (wa_2, m1_2, ss_2, wa2_2, m2_2; m the single-gather
    middles), and int32 contributions in [-1000, 1000), all from
    ``default_rng(seed)`` in the script's order; numpy."""
    rng = np.random.default_rng(seed)
    keys512 = [R.gen_keys(rng, R.SEC, R.MID) for _ in range(nsec512)]
    out = dict(zip(("wa", "wb", "ss", "wa2", "wb2"), route_sections(
        np.concatenate(keys512).astype(np.int32), 512)))
    keys128 = [R.gen_keys(rng, R.SEC2, R.MID2) for _ in range(4 * nsec512)]
    wa_2, wb_2, ss_2, wa2_2, wb2_2 = route_sections(
        np.concatenate(keys128).astype(np.int32), 128)
    out.update(wa_2=wa_2, m1_2=R.middle128(wb_2), ss_2=ss_2, wa2_2=wa2_2,
               m2_2=R.middle128(wb2_2))
    out["contrib"] = rng.integers(-1000, 1000, size=(nsec512 * R.SEC // 128,
                                                     128),
                                  dtype=np.int64).astype(np.int32)
    out["keys512"] = np.stack(keys512).astype(np.int32)
    out["keys128"] = np.stack(keys128).astype(np.int32)
    return out


def per_destination_sums(keys: np.ndarray, contrib: np.ndarray,
                         mid: int) -> np.ndarray:
    """The script's check: each section's int32 sums by destination key
    (pads dropped), (nsec * mid,) int32 wrapped."""
    nsec, sec = keys.shape
    c = contrib.reshape(nsec, sec).astype(np.int64)
    ok = (keys >= 0) & (keys < mid)
    at = (np.arange(nsec)[:, None] * mid + np.clip(keys, 0, mid - 1))
    exp = np.zeros(nsec * mid, np.int64)
    np.add.at(exp, at[ok], c[ok])
    return exp.astype(np.int32)
