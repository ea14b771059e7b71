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
    INF_BITS, K1_WINDOW, LAUNCHES, jacobi_quantize, jacobi_quantize_plain,
    jacobi_update, jacobi_update_plain, jacobi_work, k1_gather,
    k1_gather_plain, k1_gather_weighted, k1_gather_weighted_plain,
    k2_reduce, k2_reduce_min, k2_reduce_min_plain, k2_reduce_plain,
    k2_tile_cuts)
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


# ------------------------------------------------------- device loops


def _loop_graphs(device):
    """RMAT 12 (seed 5, weights from default_rng(3)) and a 64 x 64 grid,
    4-neighbour, both directions, weights uniform in [0.1, 4.0)."""
    import graph_tpu_torch as gtt
    from graph_tpu_torch.generate import host_rmat

    src, dst = host_rmat(12, seed=5)
    w = (np.random.default_rng(3).random(src.size) * 4).astype(np.float32)
    rmat = gtt.build_directed(src, dst, w, node_count=1 << 12, device=device)
    side = 64
    ii = np.arange(side * side)
    right, down = ii[ii % side != side - 1], ii[ii < side * side - side]
    gsrc = np.concatenate([right, right + 1, down, down + side])
    gdst = np.concatenate([right + 1, right, down + side, down])
    gw = np.random.default_rng(9).uniform(0.1, 4.0, gsrc.size).astype(
        np.float32)
    grid = gtt.build_directed(gsrc, gdst, gw, node_count=side * side,
                              device=device)
    return {"rmat12": (rmat, int(np.bincount(src).argmax())),
            "grid64": (grid, 0)}


def _host_loops(monkeypatch):
    """Every driver's ``device_while`` replaced by the host loop."""
    import importlib

    from graph_tpu_torch.engine.loop import host_while

    for name in ("pagerank", "wcc", "sssp"):
        mod = importlib.import_module(f"graph_tpu_torch.algos.{name}")
        monkeypatch.setattr(mod, "device_while", lambda body, state, cond,
                            **_: host_while(body, state, cond))


LOOP_PATHS = {
    "pagerank_tol": lambda gtt, g, s: gtt.page_rank(
        g, gtt.PageRankConfig(engine="plan")),
    "pagerank_tol0": lambda gtt, g, s: gtt.page_rank(
        g, gtt.PageRankConfig(engine="plan", tolerance=0.0)),
    "pagerank_cumsum": lambda gtt, g, s: gtt.page_rank(
        g, gtt.PageRankConfig(engine="cumsum", max_iterations=30,
                              tolerance=1e-6)),
    "wcc_plan": lambda gtt, g, s: gtt.wcc(g, gtt.WccConfig(engine="plan")),
    "wcc_xla": lambda gtt, g, s: gtt.wcc(g, gtt.WccConfig(engine="xla")),
    "sssp_plan": lambda gtt, g, s: gtt.delta_stepping(
        g, gtt.DeltaSteppingConfig(s, 2.0, engine="plan")),
    "sssp_xla": lambda gtt, g, s: gtt.delta_stepping(
        g, gtt.DeltaSteppingConfig(s, 2.0, engine="xla")),
    "sssp_frontier": lambda gtt, g, s: gtt.delta_stepping(
        g, gtt.DeltaSteppingConfig(s, 2.0, engine="frontier")),
}
#: The K1 and K2 kernels of each plan path, launched once a round.
LOOP_KERNELS = {"pagerank_tol": ("k1_gather", "k2_reduce", "jacobi_quantize",
                                 "jacobi_update"),
                "pagerank_tol0": ("k1_gather", "k2_reduce", "jacobi_quantize",
                                  "jacobi_update"),
                "wcc_plan": ("k1_gather", "k2_reduce_min"),
                "sssp_plan": ("k1_gather_weighted", "k2_reduce_min")}


def _result_of(res):
    for name in ("scores", "components", "distances"):
        if hasattr(res, name):
            return getattr(res, name)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("graph", ["rmat12", "grid64"])
@pytest.mark.parametrize("path", sorted(LOOP_PATHS))
def test_device_loop_bit_equal_to_host_loop_on_card(cuda_device, path,
                                                    graph, pair,
                                                    monkeypatch):
    """Each driver's device loop against its host loop on the card, a
    one-step body on two sets of buffers (``pair``) or on one: the same
    bits, the same iterations, one host read, and K1 and K2 launched once
    an iteration; a second run (from the cache) the same again."""
    import graph_tpu_torch as gtt
    from graph_tpu_torch.engine import loop

    monkeypatch.setattr(loop, "PAIR_MIN_BYTES", 0 if pair else 1 << 62)
    paired = []
    assemble = loop.DeviceLoop._assemble_pair
    monkeypatch.setattr(loop.DeviceLoop, "_assemble_pair",
                        lambda self, *a: paired.append(assemble(self, *a)))
    g, start = _loop_graphs(cuda_device)[graph]
    run = LOOP_PATHS[path]
    first = run(gtt, g, start)
    nested = path in ("sssp_xla", "sssp_frontier")
    assert len(paired) == (pair and not nested)
    LAUNCHES.update({k: 0 for k in LAUNCHES})
    got = run(gtt, g, start)  # the cached graph, new state copied in
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    with monkeypatch.context() as mp:
        _host_loops(mp)
        want = run(gtt, g, start)
    for res in (first, got):
        assert _bits_equal(_result_of(res), _result_of(want))
        assert res.ran_iterations == want.ran_iterations >= 1
        assert res.host_reads == 1
    assert want.host_reads >= 1
    for name in LOOP_KERNELS.get(path, ()):
        assert launches[name] == got.ran_iterations, (name, launches)
    if path.startswith("pagerank"):
        assert got.error == want.error


@pytest.mark.requires_cuda
@pytest.mark.parametrize("pair", [True, False])
def test_device_loop_new_inputs_and_zero_iterations_on_card(cuda_device,
                                                            pair,
                                                            monkeypatch):
    """A cached loop run with a new start node and new limits gives the
    host loop's results, on two sets of buffers or one;
    ``max_iterations=0`` returns the initial scores, as
    ``lax.while_loop`` runs no body."""
    import graph_tpu_torch as gtt
    from graph_tpu_torch.engine import loop

    monkeypatch.setattr(loop, "PAIR_MIN_BYTES", 0 if pair else 1 << 62)
    g, _ = _loop_graphs(cuda_device)["grid64"]
    # PageRank ends after an odd and an even count of bodies (the first
    # and the second set of buffers)
    cfgs = [{"max_iterations": k, "tolerance": 0.0} for k in (3, 1, 2, 4)]
    cfgs.append({"max_iterations": 50, "tolerance": 1e-5})
    runs = []
    for start in (0, 2080):
        runs.append(gtt.delta_stepping(g, gtt.DeltaSteppingConfig(start,
                                                                   2.0)))
    for cfg in cfgs:
        runs.append(gtt.page_rank(g, gtt.PageRankConfig(**cfg)))
    with monkeypatch.context() as mp:
        _host_loops(mp)
        want = [gtt.delta_stepping(g, gtt.DeltaSteppingConfig(s, 2.0))
                for s in (0, 2080)]
        want += [gtt.page_rank(g, gtt.PageRankConfig(**cfg)) for cfg in cfgs]
    for got, ref in zip(runs, want):
        assert _bits_equal(_result_of(got), _result_of(ref))
        assert got.ran_iterations == ref.ran_iterations
    assert not torch.equal(runs[0].distances, runs[1].distances)
    assert [r.ran_iterations for r in runs[2:6]] == [3, 1, 2, 4]
    assert 4 < runs[6].ran_iterations < 50
    zero = gtt.page_rank(g, gtt.PageRankConfig(max_iterations=0))
    n = g.node_count
    assert zero.ran_iterations == 0 and zero.host_reads == 1
    assert zero.error == float("inf")
    assert torch.equal(zero.scores, torch.full(
        (n,), float(np.float32(1) / np.float32(n)), device=cuda_device))


@pytest.mark.requires_cuda
def test_device_while_nested_and_raises_on_a_host_read_on_card(cuda_device):
    """A nested loop counts each loop's bodies; a body that reads the
    card from the host cannot be captured, and raises."""
    from graph_tpu_torch.engine.loop import (
        Flag, Residual, While, device_while, host_while)

    def inner(s):
        x, i, j, more, go = s
        j = j + 1
        return x + 1, i, j, j < 3, go

    def outer(s):
        x, i, j, more, go = s
        i = i + 1
        return x * 2, i, torch.zeros_like(j), i > 0, i < 4

    zero = torch.zeros((), dtype=torch.int32, device=cuda_device)
    state = (torch.ones(5, device=cuda_device), zero, zero, True, True)
    body = (While(inner, Flag(3)), outer)
    got = device_while(body, state, Flag(4))
    want = host_while(body, state, Flag(4))
    assert torch.equal(got.state[0], want.state[0])
    assert (got.iterations, got.inner) == (want.iterations, want.inner) \
        == (4, (12,))
    assert got.host_reads == 1 < want.host_reads

    def reads(s, out=None):
        x, err = s
        return x + 1, (x.sum() * float(x[0].item())) * 0
    with pytest.raises(RuntimeError):
        device_while(reads, (torch.ones(4, device=cuda_device), 1.0),
                     Residual(1, 5, 0.5))
    torch.cuda.synchronize()
    # the card still runs loops after the failed capture
    again = device_while(body, state, Flag(4))
    assert torch.equal(again.state[0], want.state[0])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("pair", [True, False])
def test_device_loop_shared_by_two_threads_on_card(cuda_device, pair,
                                                   monkeypatch):
    """Two threads run SSSP from two start nodes on one graph at once, one
    on a stream of its own: they share the graph's cached loop (both
    first calls race to capture it), and every run gives its own start
    node's host-loop distances, on two sets of buffers or one."""
    import threading

    import graph_tpu_torch as gtt
    from graph_tpu_torch.engine import loop

    monkeypatch.setattr(loop, "PAIR_MIN_BYTES", 0 if pair else 1 << 62)
    g, _ = _loop_graphs(cuda_device)["grid64"]
    starts = (0, 2080)
    with monkeypatch.context() as mp:
        _host_loops(mp)
        want = {s: gtt.delta_stepping(g, gtt.DeltaSteppingConfig(s, 2.0))
                for s in starts}
    got = {s: [] for s in starts}
    failed = []
    gate = threading.Barrier(len(starts))

    def work(s, stream):
        try:
            with torch.cuda.stream(stream):
                gate.wait()
                for _ in range(20):
                    got[s].append(gtt.delta_stepping(
                        g, gtt.DeltaSteppingConfig(s, 2.0)))
                stream.synchronize()
        except BaseException as e:  # reported below
            failed.append(e)

    threads = [threading.Thread(target=work, args=(s, stream)) for s, stream
               in zip(starts, (torch.cuda.current_stream(cuda_device),
                               torch.cuda.Stream(cuda_device)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not failed, failed
    for s in starts:
        assert len(got[s]) == 20
        for res in got[s]:
            assert _bits_equal(res.distances, want[s].distances), s
            assert res.ran_iterations == want[s].ran_iterations
            assert res.host_reads == 1


# PageRank's Jacobi tails on the plan engine: jacobi_quantize before K1,
# jacobi_update (new scores and the residual) after K2.

def _rmat_engine(scale, device):
    """RMAT ``scale`` (seed 5) on ``device``: the graph, its plan engine
    and 1/out-degree in the engine's internal order."""
    import graph_tpu_torch as gtt
    from graph_tpu_torch.algos.pagerank import _graph_engine, _inv_outdeg
    from graph_tpu_torch.generate import host_rmat

    src, dst = host_rmat(scale, seed=5)
    g = gtt.build_directed(src, dst, node_count=1 << scale, device=device)
    eng = _graph_engine(g)
    return g, eng, eng.to_internal(_inv_outdeg(g.out_degrees()))


def _tails_inputs(case, device):
    """(scores, 1/out-degree, K2's sums, base, d) of one case: RMAT 16
    after three plain Jacobi iterations, or n = 1, a block of the kernels
    (1,024 nodes) plus one, and a ragged n, with halfway quanta, nodes
    without out-edges and sums that wrap int32."""
    from graph_tpu_torch.algos.pagerank import _scalars

    if case == "rmat16":
        _, eng, inv = _rmat_engine(16, device)
        n = inv.numel()
        init, base, d = _scalars(n, 0.85)
        scores = torch.full((n,), init, device=device)
        for _ in range(3):
            acc = eng.sum_quanta(jacobi_quantize_plain(scores, inv))
            scores, _ = jacobi_update_plain(acc, scores, base, d)
        return scores, inv, eng.sum_quanta(jacobi_quantize_plain(
            scores, inv)), base, d
    n = {"n1": 1, "block_plus_one": 1025, "ragged": 4 * 4096 * 256 + 4099}[
        case]
    g = np.random.default_rng(n)
    scores = (g.random(n) * 2.0 / n).astype(np.float32)
    deg = g.integers(0, 50, n)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0).astype(np.float32)
    half = min(n, 64)
    scores[:half] = (2 * np.arange(half) + 1) / np.float32(2**31)
    inv[:half] = 1.0
    acc = g.integers(-2**31, 2**31, n).astype(np.int32)
    init, base, d = _scalars(n, 0.85)
    return (torch.from_numpy(scores).to(device),
            torch.from_numpy(inv).to(device),
            torch.from_numpy(acc).to(device), base, d)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case", ["n1", "block_plus_one", "ragged",
                                  "rmat16"])
def test_jacobi_tails_match_plain_on_card(cuda_device, case, offset):
    """Both tail kernels against their plain versions: the quanta and the
    new scores bit for bit, aligned or one element off (storage offset
    1); the residual the same bits in every launch over one scratch, and
    within 1e-6 relative of ``torch.sum``'s."""
    scores, inv, acc, base, d = _tails_inputs(case, cuda_device)
    if offset:
        scores, inv, acc = (torch.cat([t[:1], t])[1:]
                            for t in (scores, inv, acc))
    before = dict(LAUNCHES)
    xq = jacobi_quantize(scores, inv)
    assert torch.equal(xq, jacobi_quantize_plain(scores, inv))
    want, want_err = jacobi_update_plain(acc, scores, base, d)
    work = jacobi_work(scores.numel(), cuda_device)
    errs = []
    for _ in range(3):
        new, err = jacobi_update(acc, scores, base, d, work=work)
        assert _bits_equal(new, want)
        errs.append(err.clone())
    torch.cuda.synchronize()
    assert all(_bits_equal(e, errs[0]) for e in errs)
    assert abs(float(errs[0]) - float(want_err)) <= 1e-6 * float(want_err)
    assert LAUNCHES["jacobi_quantize"] == before["jacobi_quantize"] + 1
    assert LAUNCHES["jacobi_update"] == before["jacobi_update"] + 3
    assert int(work[-1].view(torch.int64)) == 0  # the ticket is back at 0


@pytest.mark.requires_cuda
def test_jacobi_wrappers_write_into_and_reject_on_card(cuda_device):
    scores, inv, acc, base, d = _tails_inputs("block_plus_one", cuda_device)
    out, err = torch.empty_like(scores), torch.empty((), device=cuda_device)
    new, e = jacobi_update(acc, scores, base, d, out, err)
    assert new is out and e is err
    assert _bits_equal(out, jacobi_update_plain(acc, scores, base, d)[0])
    empty = torch.empty(0, device=cuda_device)
    n0, e0 = jacobi_update(empty.int(), empty, base, d)
    assert n0.numel() == 0 and float(e0) == 0.0
    assert jacobi_quantize(empty, empty).numel() == 0
    with pytest.raises(TypeError):
        jacobi_quantize(scores.double(), inv)
    with pytest.raises(ValueError):
        jacobi_quantize(scores, inv[:-1])
    with pytest.raises(ValueError):
        jacobi_quantize(scores, inv.cpu())
    with pytest.raises(TypeError):
        jacobi_update(acc.float(), scores, base, d)
    with pytest.raises(ValueError):
        jacobi_update(acc, scores[::2], base, d)
    with pytest.raises(ValueError):
        jacobi_update(acc, scores, base, d, out=out[:-1])
    with pytest.raises(ValueError):
        jacobi_update(acc, scores, base, d, err=torch.empty(2,
                                                            device=cuda_device))
    with pytest.raises(ValueError):
        jacobi_update(acc, scores, base, d,
                      work=jacobi_work(4 * scores.numel(), cuda_device))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("tolerance", [1e-4, 0.0])
def test_page_rank_plan_bit_equal_to_the_op_chain_body_on_card(cuda_device,
                                                               tolerance):
    """PageRank ``plan`` at RMAT 18 (the tails kernels) against a device
    loop of the op-chain body over ``EdgeEngine.spmv``: the same scores
    bit for bit, the same iterations, the residual within 1e-6."""
    import graph_tpu_torch as gtt
    from graph_tpu_torch.algos.pagerank import _jacobi

    g, eng, inv = _rmat_engine(18, cuda_device)
    got = gtt.page_rank(g, gtt.PageRankConfig(engine="plan",
                                              tolerance=tolerance))
    scores, it, err, reads = _jacobi(lambda x: eng.spmv(x, internal=True),
                                     inv, 20, tolerance, 0.85)
    assert reads == got.host_reads == 1
    assert _bits_equal(got.scores, eng.to_public(scores))
    assert got.ran_iterations == it >= 1
    assert abs(got.error - err) <= 1e-6
