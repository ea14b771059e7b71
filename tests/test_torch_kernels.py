"""K1 and K2, in all their forms, the K1 gather probes and the K2 stream
probes, against their plain versions, on the card.

These need a CUDA device (a CUDA kernel has no CPU mode) and skip
without one.  The file imports neither JAX nor graph_tpu, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -m requires_cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from graph_tpu_torch.engine import EdgeEngine
from graph_tpu_torch.engine.kernels import (
    INF_BITS, K1_WINDOW, LAUNCHES, k1_gather, k1_gather_plain,
    k1_gather_weighted, k1_gather_weighted_plain, k2_reduce, k2_reduce_min,
    k2_reduce_min_plain, k2_reduce_plain, k2_tile_cuts)
from graph_tpu_torch.probes import k2_kernels as k2p, k2_layout
from graph_tpu_torch.probes import kernels as probes
from test_torch_tiles import TILE_CASES, _values, indptr_of


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _cases(seed=13):
    """Empty rows, a hub row longer than a block, sums that wrap int32,
    and m not a multiple of the block size."""
    g = np.random.default_rng(seed)
    counts = g.integers(0, 40, 3001)
    counts[::5] = 0
    counts[17] = 300_001
    indptr = np.concatenate([[0], np.cumsum(counts)])
    m = int(indptr[-1])
    contrib = g.integers(-2**31, 2**31, m).astype(np.int32)
    xq = g.integers(-2**31, 2**31, 1 << 12).astype(np.int32)
    slot_src = g.integers(0, xq.size, m).astype(np.int32)
    return xq, slot_src, contrib, indptr


@pytest.mark.requires_cuda
def test_kernels_match_plain_on_card(cuda_device):
    xq, slot_src, contrib, indptr = (
        torch.from_numpy(a).to(cuda_device) for a in _cases())
    assert slot_src.numel() % 256 != 0
    before = dict(LAUNCHES)
    assert torch.equal(k1_gather(xq, slot_src), k1_gather_plain(xq, slot_src))
    assert torch.equal(k2_reduce(contrib, indptr),
                       k2_reduce_plain(contrib, indptr))
    one = torch.ones(1, dtype=torch.int32, device=cuda_device)
    assert torch.equal(k1_gather(xq, one), xq[1:2])
    torch.cuda.synchronize()
    assert LAUNCHES["k1_gather"] == before["k1_gather"] + 2
    assert LAUNCHES["k2_reduce"] == before["k2_reduce"] + 1


@pytest.mark.requires_cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    xq, slot_src, contrib, indptr = (
        torch.from_numpy(a).to(cuda_device) for a in _cases(seed=3))
    with pytest.raises(TypeError):
        k1_gather(xq.long(), slot_src)
    with pytest.raises(ValueError):
        k1_gather(xq, slot_src[::2])
    with pytest.raises(ValueError):
        k2_reduce(contrib, indptr.cpu())
    with pytest.raises(TypeError):
        k2_reduce(contrib, indptr.int())


def _bits_equal(a, b):
    """Bitwise equality of 4-byte tensors (f32 compared by its bits)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _weighted_cases(g, quantize):
    """x, w for the weighted gather.  Quantized: |x op w| < 2, with exact
    half-quantum ties; f32: zeros, denormals and 3e38 among x."""
    n_src = 1 << 12
    if quantize:
        x = (g.random(n_src) * 2.6 - 1.3).astype(np.float32)
        x[:64] = (2 * np.arange(64) + 1) / np.float32(2**31)  # ties
        w = (g.random(n_src) * 2.6 - 1.3).astype(np.float32)
    else:
        x = (g.random(n_src) * 1e3).astype(np.float32)
        x[:8] = 0.0
        x[8:16] = np.arange(1, 9, dtype=np.int32).view(np.float32)
        x[16:24] = np.float32(3e38)
        w = (g.random(n_src) * 4).astype(np.float32)
    return x, w


@pytest.mark.requires_cuda
@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("combine", ["add", "mul"])
def test_k1_gather_weighted_matches_plain_on_card(cuda_device, combine,
                                                  quantize):
    g = np.random.default_rng(5)
    x, wv = _weighted_cases(g, quantize)
    _, slot_src, _, _ = _cases()
    m = slot_src.size
    w = g.choice(wv, m)
    if quantize:
        w[: m // 4] = 1.0 if combine == "mul" else 0.0  # keep the ties
    x, slot_src, w = (torch.from_numpy(a).to(cuda_device)
                      for a in (x, slot_src, w))
    before = LAUNCHES["k1_gather_weighted"]
    got = k1_gather_weighted(x, slot_src, w, combine, quantize)
    want = k1_gather_weighted_plain(x, slot_src, w, combine, quantize)
    torch.cuda.synchronize()
    assert got.dtype == (torch.int32 if quantize else torch.float32)
    assert _bits_equal(got, want)
    assert LAUNCHES["k1_gather_weighted"] == before + 1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("op", ["imin", "min"])
def test_k2_reduce_min_matches_plain_on_card(cuda_device, op):
    """Empty rows (the fill), a 300,001-slot hub row, negative int32 for
    imin, f32 zeros, denormals and 3e38 (and above) for min."""
    _, _, contrib, indptr = _cases(seed=21)
    if op == "min":  # nonnegative f32 bit patterns
        contrib = contrib & np.int32(0x7FFFFFFF)
        contrib[::97] = 0
        contrib[1::97] = np.arange(contrib[1::97].size) % 0x7FFFFF + 1
        contrib[2::97] = INF_BITS
        contrib[3::97] = np.float32(np.finfo(np.float32).max).view(np.int32)
    else:
        assert (contrib < 0).any()
    contrib, indptr = (torch.from_numpy(a).to(cuda_device)
                       for a in (contrib, indptr))
    before = LAUNCHES["k2_reduce_min"]
    got = k2_reduce_min(contrib, indptr, op)
    want = k2_reduce_min_plain(contrib, indptr, op)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert LAUNCHES["k2_reduce_min"] == before + 1
    empty = torch.diff(indptr) == 0
    assert bool(empty.any())
    assert bool((got[empty] == (INF_BITS if op == "min" else 2**31 - 1)).all())


@pytest.mark.requires_cuda
def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    xq, slot_src, contrib, indptr = (
        torch.from_numpy(a).to(cuda_device) for a in _cases(seed=3))
    x = xq.float()
    w = torch.ones(slot_src.numel(), device=cuda_device)
    with pytest.raises(TypeError):
        k1_gather_weighted(xq, slot_src, w, "add", True)
    with pytest.raises(ValueError):
        k1_gather_weighted(x, slot_src, w[:-1], "add", True)
    with pytest.raises(ValueError):
        k1_gather_weighted(x, slot_src, w.cpu(), "mul", False)
    with pytest.raises(ValueError):
        k1_gather_weighted(x, slot_src[::2], w[::2], "mul", False)
    with pytest.raises(ValueError):
        k1_gather_weighted(x, slot_src, w, "max", False)
    with pytest.raises(TypeError):
        k2_reduce_min(contrib.float(), indptr, "min")
    with pytest.raises(ValueError):
        k2_reduce_min(contrib, indptr.cpu(), "imin")
    with pytest.raises(ValueError):
        k2_reduce_min(contrib, indptr, "max")


@pytest.mark.requires_cuda
def test_engine_ops_on_card_equal_cpu(cuda_device):
    """Every engine op on the card equals the port's CPU path bit for bit."""
    g = np.random.default_rng(8)
    n, m = 5000, 60000
    src = (g.zipf(1.3, m) % n).astype(np.int64)
    dst = g.integers(0, n, m)
    w = (g.random(m) * 1e-3).astype(np.float32)
    x = (g.random(n) * 1e-3).astype(np.float32)
    xi = g.integers(0, 1 << 30, n).astype(np.int32)
    engines = [EdgeEngine.build(src, dst, n, values=w, relabel="degree",
                                device=d) for d in ("cpu", cuda_device)]
    outs = []
    for eng in engines:
        xd = torch.from_numpy(x).to(eng.device)
        outs.append([eng.apply(xd, combine=c, reduce=r)
                     for c in ("none", "add", "mul") for r in ("sum", "min")]
                    + [eng.smin_int(torch.from_numpy(xi).to(eng.device))])
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert _bits_equal(a, b.cpu())


# The redesigned kernels' edges: K2's merge-path tiles and K1's window and
# 16-byte streams, each against its plain version bit for bit.

def _k2_pair(op):
    """(kernel, plain, launch-count name) of one K2 op."""
    if op == "sum":
        return k2_reduce, k2_reduce_plain, "k2_reduce"
    return ((lambda c, ip, cuts=None: k2_reduce_min(c, ip, op, cuts)),
            (lambda c, ip: k2_reduce_min_plain(c, ip, op)), "k2_reduce_min")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("op", ["sum", "imin", "min"])
@pytest.mark.parametrize("case", list(TILE_CASES))
def test_k2_merge_path_edges_on_card(cuda_device, case, op, offset):
    """A row ending on a tile boundary, a row over 4 tiles among empty
    rows, n = 1, m below one tile, a power-law plan; values that wrap
    int32 sums and negative imin values; contrib at storage offsets 1-3
    (not 16-byte aligned).  One launch per call, cuts given or not."""
    indptr = indptr_of(TILE_CASES[case]())
    m = int(indptr[-1])
    base = torch.from_numpy(_values(m + offset, op, seed=offset)).to(
        cuda_device)
    contrib = base[offset:]
    assert contrib.storage_offset() == offset and contrib.is_contiguous()
    ip = torch.from_numpy(indptr).to(cuda_device)
    kernel, plain, name = _k2_pair(op)
    want = plain(contrib, ip)
    before = LAUNCHES[name]
    got = kernel(contrib, ip)
    got_cuts = kernel(contrib, ip, k2_tile_cuts(ip, m))
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_cuts, want)
    assert LAUNCHES[name] == before + 2


def _k1_call(form, x, src, w, window):
    """(kernel output, plain output) of one K1 form."""
    if form == "gather":
        xi = x.view(torch.int32)
        return k1_gather(xi, src, window), k1_gather_plain(xi, src)
    combine, quantize = form.split("_")[0], form.endswith("_q")
    return (k1_gather_weighted(x, src, w, combine, quantize, window=window),
            k1_gather_weighted_plain(x, src, w, combine, quantize))


def _view(a, offset, device):
    """a as a contiguous view at storage offset ``offset``."""
    base = torch.zeros(a.size + offset, dtype=torch.from_numpy(a).dtype)
    base[offset:] = torch.from_numpy(a)
    return base.to(device)[offset:]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("window", [0, 1000, 4096, 10_000])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("form", ["gather", "add", "mul", "add_q", "mul_q"])
def test_k1_window_and_offsets_on_card(cuda_device, form, offset, window):
    """Windows of 0, part of, all of and more than the 4,096 sources;
    x, slot_src and w at storage offsets 1-3 (w's differs from slot_src's
    but for 0 and 2); m = 50,003, not a multiple of 4.  Sources are skewed
    to low ids, as on a relabeled plan, so both the window and the L2
    serve gathers."""
    g = np.random.default_rng(17 + offset)
    quantize = form.endswith("_q")
    x, wv = _weighted_cases(g, quantize)
    m = 50_003
    src = np.minimum(g.zipf(1.5, m) - 1, x.size - 1).astype(np.int32)
    src[::7] = g.integers(0, x.size, src[::7].size)
    w = g.choice(wv, m)
    if quantize:
        w[: m // 4] = 1.0 if form.startswith("mul") else 0.0  # keep ties
    xd, srcd = _view(x, offset, cuda_device), _view(src, offset, cuda_device)
    wd = _view(w, (3 * offset) % 4, cuda_device)
    name = "k1_gather" if form == "gather" else "k1_gather_weighted"
    before = LAUNCHES[name]
    got, want = _k1_call(form, xd, srcd, wd, window)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)
    assert LAUNCHES[name] == before + 1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("m", [1, 3, 4, 7, 8, 9])
@pytest.mark.parametrize("form", ["gather", "add", "mul_q"])
def test_k1_short_streams_on_card(cuda_device, form, m):
    """Fewer slots than one vector, or a vector and a ragged tail."""
    g = np.random.default_rng(m)
    x, wv = _weighted_cases(g, form.endswith("_q"))
    src = g.integers(0, x.size, m).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (x, src, g.choice(wv, m))]
    got, want = _k1_call(form, *args, K1_WINDOW)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)


def _probe_stream(g, nrows, win):
    """An in-range stream for every probe at window ``win``: idx < win,
    lanemap's row field (bits 8-14) below win/128, bit 7 at random."""
    idx = g.integers(0, win, (nrows, 128))
    st = g.integers(0, win // 128, (nrows, 128)) << 8 | (idx & 255)
    return idx.astype(np.uint16), st.astype(np.uint16)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("nrows", [1, 31, 33, 1000])
@pytest.mark.parametrize("win", [1024, 3072, 16384])
def test_probes_match_plain_on_card(cuda_device, win, nrows, offset):
    """Every probe at ragged row counts (chunks of 32 rows), windows of
    one group, three groups and the largest, and x or t off 16-byte
    alignment (storage offset 1)."""
    g = np.random.default_rng(win + nrows + offset)
    idx_np, st_np = _probe_stream(g, nrows, win)
    idx, st = (torch.from_numpy(a).to(cuda_device) for a in (idx_np, st_np))
    x = _view(g.random(win).astype(np.float32), offset, cuda_device)
    before = dict(probes.LAUNCHES)
    pairs = [(probes.lanemap(st, x), probes.lanemap_plain(st, x)),
             (probes.sublane(idx, x), probes.sublane_plain(idx, x))]
    for mode in probes.MODES:
        pairs.append((probes.window_gather(idx, x, mode),
                      probes.window_gather_plain(idx, x, mode)))
    for rows in (1, 8, 128):
        t = _view(g.random(rows * 128).astype(np.float32), offset,
                  cuda_device).view(rows, 128)
        pairs.append((probes.row_gather(idx, t),
                      probes.row_gather_plain(idx, t)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.shape == (nrows, 128) and _bits_equal(got, want)
    assert {k: probes.LAUNCHES[k] - before[k] for k in before} == {
        "probe_row_gather": 3, "probe_lanemap": 1,
        "probe_window_gather": 2, "probe_sublane": 1}


@pytest.mark.requires_cuda
def test_probe_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    idx = torch.zeros(4, 128, dtype=torch.uint16, device=cuda_device)
    x = torch.zeros(1024, device=cuda_device)
    with pytest.raises(TypeError):
        probes.sublane(idx.to(torch.int32), x)
    with pytest.raises(ValueError):
        probes.lanemap(idx[:, :64], x)
    with pytest.raises(ValueError):
        probes.window_gather(idx, torch.zeros(16385, device=cuda_device),
                             "rowscan")
    with pytest.raises(ValueError):
        probes.row_gather(idx, torch.zeros(129, 128, device=cuda_device))
    with pytest.raises(ValueError):
        probes.row_gather(idx.cpu(), torch.zeros(8, 128, device=cuda_device))
    empty = idx[:0]
    assert probes.sublane(empty, x).shape == (0, 128)


def _k2_case(g, nsteps, nout, passes, zero_p, rows=48, h=8):
    """Random steps over ``rows`` rows of v: overlapping rows, chains of
    up to ``passes * nsteps`` steps into ``nout`` blocks (one more block
    is never touched)."""
    return k2_layout.Steps(
        g.integers(0, rows - h + 1, nsteps).astype(np.int64),
        g.integers(0, nout, nsteps).astype(np.int64),
        g.random(nsteps) < zero_p, h, nout + 1, passes)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seed", range(8))
def test_sec_stream_matches_plain_on_card(cuda_device, seed):
    """Both stream kernels on random step lists (chains longer than a
    piece, some blocks never zeroed), every T with full and touched u16
    and int32 sides (one 640 wide), a random init; the f32 kernel from 0,
    NaN and a random init."""
    g = np.random.default_rng(seed)
    steps = _k2_case(g, int(g.integers(1, 120)), int(g.integers(1, 4)),
                     int(g.integers(1, 4)), 0.05 * seed)
    dev = cuda_device
    v_round = torch.from_numpy(
        (g.random((48, 128)) * 3.8 - 1.9).astype(np.float32)).to(dev)
    u16 = [torch.from_numpy(g.integers(0, 1 << 16, (48, 128)).astype(
        np.uint16)).to(dev) for _ in range(3)]
    i32 = [torch.from_numpy(g.integers(-2**31, 2**31, (48, 128)).astype(
        np.int32)).to(dev) for _ in range(2)]
    init = int(g.integers(-2**31, 2**31))
    sched = k2p.schedule(steps, dev)
    before = dict(k2p.LAUNCHES)
    pairs = []
    for mode in k2p.MODES:
        for read, sides in (("full", u16 + i32),
                            ("touch", i32 + [torch.cat(u16 + u16[:2], 1)])):
            pairs.append((k2p.sec_stream(v_round, sides, sched, mode, read,
                                         init),
                          k2p.sec_stream_plain(v_round, sides, steps, mode,
                                               read, init)))
    ordered = k2p.schedule(steps, dev, ordered=True)
    for f_init in (0.0, float("nan"), float(g.random())):
        pairs.append((k2p.sec_stream_f32(v_round, u16 + i32, ordered,
                                         f_init),
                      k2p.sec_stream_f32_plain(v_round, u16 + i32, steps,
                                               f_init)))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.shape == (steps.nout * 8, 128) and _bits_equal(got, want)
    assert {k: k2p.LAUNCHES[k] - before[k] for k in before} == {
        "probe_sec_stream": 6, "probe_sec_stream_f32": 3}


@pytest.mark.requires_cuda
def test_sec_stream_wrappers_reject_what_the_kernels_do_not_take(
        cuda_device):
    g = np.random.default_rng(0)
    steps = _k2_case(g, 10, 2, 1, 0.5)
    dev = cuda_device
    v = torch.zeros(49 * 128, device=dev)
    side = torch.zeros(48, 128, dtype=torch.uint16, device=dev)
    sched = k2p.schedule(steps, dev)
    with pytest.raises(ValueError, match="aligned"):
        k2p.sec_stream(v[1:1 + 48 * 128].view(48, 128), [side], sched,
                       "round", "full")
    v = v[:48 * 128].view(48, 128)
    with pytest.raises(TypeError):
        k2p.sec_stream(v, [side.to(torch.int64)], sched, "round", "full")
    with pytest.raises(ValueError):
        k2p.sec_stream(v, [torch.cat([side] * 5, 1)], sched, "round", "full")
    with pytest.raises(ValueError):
        k2p.sec_stream(v[:steps.rows_needed - 1], [], sched, "trunc", "full")
    with pytest.raises(ValueError, match="ordered"):
        k2p.sec_stream_f32(v, [side], sched)
    with pytest.raises(ValueError, match="schedule"):
        k2p.sec_stream(v, [side], k2p.schedule(steps, "cpu"), "round",
                       "full")
    empty = k2_layout.Steps(np.zeros(0, np.int64), np.zeros(0, np.int64),
                            np.zeros(0, np.bool_), 8, 2)
    before = dict(k2p.LAUNCHES)
    out = k2p.sec_stream(v, [side], k2p.schedule(empty, dev), "round",
                         "touch", 5)
    assert out.shape == (16, 128) and bool((out == 5).all())
    assert k2p.LAUNCHES == before


def _stage_programs():
    """(rows, program, sides as u16 / u8 dtypes) of every stage kind."""
    from graph_tpu_torch.probes import k2_stage_kernels as ks

    out = [(512, p) for p in ks.STAGES.values()]
    out += [(512, ks.K2V2["full"]), (512, ks.ROUTE_OPS["taa2"]),
            (512, ks.ROUTE_OPS["c_roll"]), (512, ks.ROUTE_OPS["both_routes"]),
            (512, ks.FULL_INT), (512, ks.C_ONLY)]
    out += [(128, ks.sec128_program(s, ls, rs))
            for s, ls, rs in ((4, 7, 7), (1, 7, 7), (3, 5, 2))]
    out += list(ks.TRANSPOSE.values())
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seed", range(3))
def test_stage_probes_match_plain_on_card(cuda_device, seed):
    """Every stage kind of both stage kernels on random sides (routes that
    are no permutations, u8 and u16), random steps over four sections
    (chains longer than a piece, blocks never zeroed, overlapping
    sections) into one to four outputs, a random init; ``meta`` with
    random windows inside the section."""
    from graph_tpu_torch.probes import k2_routes, k2_stage_kernels as ks

    g = np.random.default_rng(seed)
    dev = cuda_device
    nsec = 4

    def t(a):
        return torch.from_numpy(a).to(dev)

    vf = t((g.random((nsec * 512, 128)) * 3.8 - 1.9).astype(np.float32))
    vi = t(g.integers(-2**31, 2**31, (nsec * 512, 128)).astype(np.int32))
    u16 = [t(g.integers(0, 1 << 16, (nsec * 512, 128)).astype(np.uint16))
           for _ in range(5)]
    u16[2] = t(np.sort(g.integers(0, 1 << 16, (nsec * 512, 128)).astype(
        np.uint16), axis=None).reshape(-1, 128))
    meta = k2_routes.stages_meta(nsec).reshape(nsec, 129)
    meta[:, 1:65] = g.integers(0, 48, (nsec, 64)) * 1024
    meta[:, 65:] = g.integers(0, 3, (nsec, 64))
    meta = meta.reshape(-1)
    init = int(g.integers(-2**31, 2**31))
    before = dict(ks.LAUNCHES)
    launched = {k: 0 for k in before}
    for rows, program in _stage_programs():
        n = nsec * 512 // rows
        nouts = 1 if rows == 512 else int(g.integers(1, 5))
        steps_list = [k2_layout.Steps(
            g.integers(0, n, 40).astype(np.int64) * rows,
            g.integers(0, 3, 40).astype(np.int64), g.random(40) < 0.1, rows,
            4, int(g.integers(1, 3))) for _ in range(nouts)]
        compact = any(op[0] == "compact" for op in program)
        sched = ks.schedule(steps_list, dev, meta if compact else None)
        v = vi if program[0][1] == "int" else vf
        sides = u16 if rows == 512 else [u16[0], u16[1].to(torch.uint8) & 127,
                                         u16[2], u16[3], u16[4].to(
                                             torch.uint8) & 127]
        if rows == 512:
            got = [ks.sec_route(v, sides, program, sched, init)]
            launched["probe_sec_route"] += 1
        else:
            got = ks.sec128(v, sides, program, sched, init)
            launched["probe_sec128"] += 1
        want = ks.stage_plain(v, sides, program, steps_list, sched.meta,
                              init)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert _bits_equal(a, b), program
    assert {k: ks.LAUNCHES[k] - before[k] for k in before} == launched


def _stage_512_cases():
    """The 512-row edge cases (as chip_smoke's): the route program at the
    scan's lane and row depths (0, 0), (7, 0), (0, 9), (1, 9), (7, 9);
    prefix sums alone and before the compaction; a load in the Y layout
    with TI, gathers, T and the C stage; the transpose bodies and the C
    stage alone; every side added and masked and a constant; a trunc
    load with a pad side, a gather by shift 7, a mask and a touch."""
    from graph_tpu_torch.probes import k2_stage_kernels as ks

    programs = [(("load", "round", 1), *ks.route(1, 2), ("scan", 3, *d),
                 *ks.route(4, 5), ("mask", 4))
                for d in ((7, 9), (0, 0), (7, 0), (0, 9), (1, 9))]
    return programs + [
        (("load", "int"), ("psum",)),
        (("load", "int"), *ks.route(1, 2), ("psum",), ("compact", 3)),
        (("load", "int", 0, 1), ("ti",), ("gather", 2, 3), ("t",),
         ("gather", 0, 13), ("c", 1), ("ti",), ("add_touch", 5)),
        ks.TRANSPOSE["t512x2"][1], ks.TRANSPOSE["taa512"][1], ks.C_ONLY,
        (("load", "int"), *(("add_full", s) for s in range(1, 6)),
         *(("mask", s) for s in range(1, 5)), ("add_const", -7)),
        (("load", "trunc", 3), ("gather", 1, 7), ("mask", 3),
         ("add_touch", 2))]


def _stage_512_layouts():
    """(steps of each output, init): three sections with a mid of one;
    a block never zeroed over two passes; a chain of six into one block
    (one piece: the next section's v and sides fetched ahead); a chain of
    ten (pieces of eight and two, added); two and four outputs."""
    from graph_tpu_torch.probes.k2_layout import first_of_mid

    def steps(sm, nout, zero=None, passes=1, first=0, row0=None):
        sm = np.asarray(sm, np.int64)
        if row0 is None:
            row0 = first + np.arange(len(sm), dtype=np.int64)
        return k2_layout.Steps(
            np.asarray(row0, np.int64) * 512, sm,
            np.asarray(first_of_mid(sm) if zero is None else zero, np.bool_),
            512, nout, passes)

    quad = [steps([i], 4, first=i) for i in range(4)]
    return (([steps([0, 1, 1], 3)], 0),
            ([steps([1, 1], 2, [False] * 2, 2)], -5),
            ([steps([0] * 6 + [1] * 2, 2)], 3),
            ([steps([0] * 10 + [1] * 2, 2, row0=np.arange(12) % 6)], 11),
            (quad[:2], -(1 << 31)), (quad, 1 << 30))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("widths", ["u16", "u8 and u16", "u8"])
def test_stage_512_edge_cases_match_plain_on_card(cuda_device, widths):
    """``probe_sec_route`` bit for bit against its plain version on every
    512-row edge case, one to four outputs, sides of one width or both."""
    from graph_tpu_torch.probes import k2_routes, k2_stage_kernels as ks

    g = np.random.default_rng(43)
    dev = cuda_device

    def t(a):
        return torch.from_numpy(a).to(dev)

    u16 = [t(g.integers(0, 1 << 16, (8 * 512, 128)).astype(np.uint16))
           for _ in range(5)]
    sides = {"u16": u16,
             "u8 and u16": [u16[0], u16[1].to(torch.uint8), u16[2], u16[3],
                            u16[4].to(torch.uint8)],
             "u8": [s.to(torch.uint8) for s in u16]}[widths]
    vf = t((g.random((8 * 512, 128)) * 3.8 - 1.9).astype(np.float32))
    vi = t(g.integers(-2**31, 2**31, (8 * 512, 128)).astype(np.int32))
    meta = k2_routes.stages_meta(8).reshape(8, 129)
    meta[:, 1:65] = g.integers(0, 48, (8, 64)) * 1024
    meta[:, 65:] = g.integers(0, 3, (8, 64))
    meta = meta.reshape(-1)
    before = ks.LAUNCHES["probe_sec_route"]
    n = 0
    for program in _stage_512_cases():
        v = vi if program[0][1] == "int" else vf
        m = meta if any(op[0] == "compact" for op in program) else None
        for steps_list, init in _stage_512_layouts():
            sched = ks.schedule(steps_list, dev, m)
            got = ks.sec_route_outs(v, sides, program, sched, init)
            want = ks.stage_plain(v, sides, program, steps_list, sched.meta,
                                  init)
            torch.cuda.synchronize()
            assert len(got) == len(steps_list)
            for a, b in zip(got, want):
                assert _bits_equal(a, b), (program, init)
            n += 1
    assert ks.LAUNCHES["probe_sec_route"] - before == n
