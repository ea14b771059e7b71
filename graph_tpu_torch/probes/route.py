"""The TPU plan's section router, for the K2 stage probes.

The port's plan is a destination-sorted CSR and routes nothing; the K2
stage probes (:mod:`graph_tpu_torch.probes.k2_stage_kernels`) time the
TPU's own design, which permutes each section of R rows x 128 lanes
through two Clos/Benes networks computed on the host.  These are the
port's copies of that router: ``graph_tpu/engine/route.py`` (the
five-stage Clos decomposition by Euler-split edge coloring, its numpy
reference and the u16 packing), ``graph_tpu/engine/plan.py``'s
``_section_python`` (one 512-row section), and
``scripts/perf_k2_sec128.py``'s ``gen_keys`` and ``section128_python``
(one 128-row section with a single-gather middle).

A permutation of N = R * 128 positions is decomposed into

    A:  lane gather within rows of the (R, 128) layout
    T:  transpose to (128, R) viewed as (128, R1, 128), R1 = R // 128
    B:  lane gather within the last axis
    C:  gather along the middle (R1) axis
    D:  lane gather within the last axis
    T': transpose back to (R, 128)
    E:  lane gather within rows

Stage A routes every element into the intermediate column assigned by a
128-edge-coloring of the bipartite input-row/output-row multigraph; the
per-column R-permutation (B-D) is the same argument on the (R1, 128)
view.  This pure-Python router is slow (seconds a section); the native
copy (:mod:`graph_tpu_torch.native.edge_plan`) routes whole layouts.
"""

from __future__ import annotations

import numpy as np

#: A 512-row section, its destinations a mid (pad keys -1 and MID).
SEC_R = 512
SEC = SEC_R * 128
MID = 65536
#: ``perf_k2_sec128.py``'s 128-row sections.
SEC_R2 = 128
SEC2 = SEC_R2 * 128
MID2 = 16384


def euler_split(left: np.ndarray, right: np.ndarray, nl: int, nr: int,
                d: int) -> np.ndarray:
    """Split a d-regular bipartite multigraph (d even) into two halves.

    Returns half in {0,1} per edge; each node has exactly d/2 edges in
    each half (alternate edges of an Euler partition).
    """
    e_cnt = left.size
    ladj = np.empty((nl, d), np.int64)
    radj = np.empty((nr, d), np.int64)
    lcnt = np.zeros(nl, np.int64)
    rcnt = np.zeros(nr, np.int64)
    for e in range(e_cnt):
        lft = left[e]
        rgt = right[e]
        ladj[lft, lcnt[lft]] = e
        lcnt[lft] += 1
        radj[rgt, rcnt[rgt]] = e
        rcnt[rgt] += 1
    used = np.zeros(e_cnt, bool)
    lptr = np.zeros(nl, np.int64)
    rptr = np.zeros(nr, np.int64)
    half = np.empty(e_cnt, np.int8)
    for e0 in range(e_cnt):
        if used[e0]:
            continue
        e = e0
        h = 0
        while True:
            used[e] = True
            half[e] = h
            h ^= 1
            rn = right[e]
            while rptr[rn] < d and used[radj[rn, rptr[rn]]]:
                rptr[rn] += 1
            if rptr[rn] == d:
                break
            e = radj[rn, rptr[rn]]
            used[e] = True
            half[e] = h
            h ^= 1
            ln = left[e]
            while lptr[ln] < d and used[ladj[ln, lptr[ln]]]:
                lptr[ln] += 1
            if lptr[ln] == d:
                break
            e = ladj[ln, lptr[ln]]
    return half


def edge_color(left: np.ndarray, right: np.ndarray, nl: int, nr: int,
               d: int) -> np.ndarray:
    """d-edge-color a d-regular bipartite multigraph (d a power of two)."""
    if d == 1:
        return np.zeros(left.size, np.int64)
    half = euler_split(left, right, nl, nr, d)
    colors = np.empty(left.size, np.int64)
    for h in (0, 1):
        m = half == h
        sub = edge_color(left[m], right[m], nl, nr, d // 2)
        colors[m] = sub * 2 + h
    return colors


def _route_small(q_inv: np.ndarray, r1: int):
    """Route a permutation of R = r1*128 as lane/middle/lane stages:
    (B, C, D), each (r1, 128), with y3[t // 128, t % 128] ==
    y[s // 128, s % 128] for t = q_inv[s]."""
    rr = r1 * 128
    s = np.arange(rr)
    t = q_inv
    g_in, lane_in = s // 128, s % 128
    g_out, lane_out = t // 128, t % 128
    k2 = edge_color(g_in, g_out, r1, r1, 128)
    b_idx = np.empty((r1, 128), np.int32)
    c_idx = np.empty((r1, 128), np.int32)
    d_idx = np.empty((r1, 128), np.int32)
    b_idx[g_in, k2] = lane_in
    c_idx[g_out, k2] = g_in
    d_idx[g_out, lane_out] = k2
    return b_idx, c_idx, d_idx


def clos_route(target: np.ndarray, r: int) -> dict:
    """Decompose a permutation of N = r*128 into the five index stages.

    ``target[i]`` = output flat position of input flat position i.
    Returns A (r,128), B, C, D (128,r1,128) and E (r,128) such that
    :func:`clos_apply_reference` maps x.flat[i] to position target[i].
    """
    n = r * 128
    r1 = r // 128
    assert r1 * 128 == r
    i = np.arange(n)
    r_in, c_in = i // 128, i % 128
    r_out, c_out = target // 128, target % 128
    k = edge_color(r_in, r_out, r, r, 128)

    a_idx = np.empty((r, 128), np.int32)
    e_idx = np.empty((r, 128), np.int32)
    a_idx[r_in, k] = c_in
    e_idx[r_out, c_out] = k

    b_idx = np.empty((128, r1, 128), np.int32)
    c_idx = np.empty((128, r1, 128), np.int32)
    d_idx = np.empty((128, r1, 128), np.int32)
    for col in range(128):
        m = k == col
        q_inv = np.empty(r, np.int64)
        q_inv[r_in[m]] = r_out[m]
        b_idx[col], c_idx[col], d_idx[col] = _route_small(q_inv, r1)
    return {"A": a_idx, "B": b_idx, "C": c_idx, "D": d_idx, "E": e_idx}


def clos_apply_reference(x: np.ndarray, idx: dict) -> np.ndarray:
    """Numpy reference of the stage sequence. x: (r, 128)."""
    r = x.shape[0]
    r1 = r // 128
    a, b, c, d, e = idx["A"], idx["B"], idx["C"], idx["D"], idx["E"]
    x1 = np.take_along_axis(x, a, axis=1)
    y = x1.T.reshape(128, r1, 128)
    y1 = np.take_along_axis(y, b, axis=2)
    y2 = np.take_along_axis(y1, c, axis=1)
    y3 = np.take_along_axis(y2, d, axis=2)
    z = y3.reshape(128, r).T.copy()
    return np.take_along_axis(z, e, axis=1)


def pack_routing(idx: dict, pad_mask=None, out_mask=None):
    """Pack the stages into two u16 streams: ``wa = A | E << 7 | flag <<
    15`` (r, 128) and ``wb = B | C << 7 | D << 9`` (128, r1, 128), the
    flag a pad mask at the input layout (route 1) or a present mask at
    the output layout (route 2)."""
    r1 = idx["B"].shape[1]
    assert r1 <= 4, "wB packing supports r1 <= 4 (section <= 64K edges)"
    assert pad_mask is None or out_mask is None
    wa = idx["A"].astype(np.uint16) | (idx["E"].astype(np.uint16) << 7)
    if pad_mask is not None:
        wa |= pad_mask.astype(np.uint16) << 15
    if out_mask is not None:
        wa |= out_mask.astype(np.uint16) << 15
    wb = (idx["B"].astype(np.uint16)
          | (idx["C"].astype(np.uint16) << 7)
          | (idx["D"].astype(np.uint16) << 9))
    return wa, wb


def ends_to_dst_perm(s_key: np.ndarray, mid: int):
    """Route 2's permutation of one section: each present destination's
    segment end goes to output position d, every other position fills the
    remaining outputs in order.  Returns (target2, present (mid,) bool)."""
    n = s_key.size
    cnt_le = np.searchsorted(s_key, np.arange(mid), side="right")
    cnt_lt = np.searchsorted(s_key, np.arange(mid), side="left")
    present = cnt_le > cnt_lt
    e_d = cnt_le - 1  # >= 0: the lead pad precedes d = 0
    target2 = np.full(n, -1, np.int64)
    dsts = np.nonzero(present)[0]
    target2[e_d[present]] = dsts
    used_out = np.zeros(n, bool)
    used_out[dsts] = True
    target2[target2 < 0] = np.nonzero(~used_out)[0]
    return target2, present


def section_python(keys: np.ndarray):
    """Route one 512-row section (``plan.py``'s ``_section_python``):
    (wa, wb, sstart, wa2, wb2), each (512, 128) u16."""
    sort_order = np.argsort(keys, kind="stable")
    target = np.empty(SEC, np.int64)
    target[sort_order] = np.arange(SEC)
    idx = clos_route(target, SEC_R)
    pad = ((keys == -1) | (keys == MID)).reshape(SEC_R, 128)
    wa_s, wb_s = pack_routing(idx, pad)
    s_key = keys[sort_order]
    ss_s = np.searchsorted(s_key, s_key, side="left")
    target2, present = ends_to_dst_perm(s_key, MID)
    idx2 = clos_route(target2, SEC_R)
    wa2_s, wb2_s = pack_routing(idx2, out_mask=present.reshape(SEC_R, 128))
    return (wa_s, wb_s.reshape(SEC_R, 128),
            ss_s.astype(np.uint16).reshape(SEC_R, 128),
            wa2_s, wb2_s.reshape(SEC_R, 128))


def gen_keys(rng, sec: int, mid: int) -> np.ndarray:
    """``perf_k2_sec128.py``'s synthetic section: segments of geometric
    (mean 16, at most 2,048) length on sorted random destinations, one
    lead pad -1, tail pads ``mid``, in a shuffled input order."""
    lens = rng.geometric(1.0 / 16.0, size=sec // 4)
    lens = np.minimum(lens, 2048)
    cum = np.cumsum(lens)
    k = int(np.searchsorted(cum, sec - 64))
    lens = lens[:k]
    used = int(cum[k - 1]) if k else 0
    dsts = np.sort(rng.choice(mid, size=k, replace=False))
    keys_sorted = np.concatenate(
        [[-1], np.repeat(dsts, lens),
         np.full(sec - 1 - used, mid, np.int64)])
    perm = rng.permutation(sec)
    return keys_sorted[perm]


def middle128(wb: np.ndarray) -> np.ndarray:
    """A 128-row route's single-gather middle ``M[k, j] = B[k, D[k, j]]``
    (C is 0 when R1 = 1) from its packed (128, 128) ``wb``, as u8."""
    w = wb.astype(np.int64).reshape(-1, 128, 128)
    b, d = w & 127, (w >> 9) & 127
    assert not ((w >> 7) & 3).any()
    return np.take_along_axis(b, d, axis=2).astype(np.uint8).reshape(
        wb.shape)


def section128_python(keys: np.ndarray):
    """Route one 128-row section (``section128_python``): (wa u16, m1 u8,
    ss u16, wa2 u16, m2 u8), each (128, 128)."""
    sort_order = np.argsort(keys, kind="stable")
    target = np.empty(SEC2, np.int64)
    target[sort_order] = np.arange(SEC2)
    idx = clos_route(target, SEC_R2)
    pad = ((keys == -1) | (keys == MID2)).reshape(SEC_R2, 128)
    wa, wb = pack_routing(idx, pad)
    s_key = keys[sort_order]
    ss = np.searchsorted(s_key, s_key, side="left").astype(np.uint16)
    target2, present = ends_to_dst_perm(s_key, MID2)
    idx2 = clos_route(target2, SEC_R2)
    wa2, wb2 = pack_routing(idx2, out_mask=present.reshape(SEC_R2, 128))
    return (wa, middle128(wb.reshape(SEC_R2, 128)), ss.reshape(SEC_R2, 128),
            wa2, middle128(wb2.reshape(SEC_R2, 128)))
