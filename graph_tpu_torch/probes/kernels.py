"""The K1 gather probes' kernels, with their plain versions.

Counterparts of the four Pallas kernels of ``scripts/perf_k1_lanemap.py``,
``perf_k1_rowmatch.py`` and ``perf_k1_sublane.py``, written by hand in
CUDA C++ for Hopper (``graph_tpu_torch/csrc/k1_probes.cu``).  A stream
``idx`` is (nrows, 128) u16: row r, lane j.  Each computes, on any
in-range input, what its TPU kernel computes:

* :func:`row_gather` (depth probe): ``out[r,j] = t[idx[r,j] mod R, j]``,
  t (R, 128) f32;
* :func:`lanemap`: ``lo = st & 127``, ``A = (st >> 8) & 127``,
  ``out[r,j] = x[128*A[r, lo[r,j]] + lo[r,j]]`` (A < win/128);
* :func:`window_gather`: ``"rowscan"`` ``x[idx]``; ``"rowmatch"``
  ``x[128*(8*(idx>>10) + r mod 8) + (idx & 127)]``, which is ``x[idx]``
  only on row-matched input (``(idx >> 7) & 7 == r mod 8``);
* :func:`sublane`: ``hi = idx >> 7``, ``lo = idx & 127``,
  ``x[128*(8*(hi[r,j]>>3) + (hi[r, lo[r,j]] & 7)) + lo[r,j]]``: the
  sublane is read at the final lane, so it is ``x[idx]`` on about one
  slot in eight.

x is (win,) f32 and idx < win.  Each wrapper runs its plain version for
tensors on the CPU.  For CUDA tensors it checks device, dtype, shape and
contiguity, launches its kernel on the current stream (building it at
first use) and raises if the launch reports an error; it never falls
back to the plain version on the card.  ``LAUNCHES`` counts the kernel
launches.
"""

from __future__ import annotations

import torch

from graph_tpu_torch.engine import _build

LANES = 128
#: Largest table depth R and window: 64 KB of shared memory.
TABLE_ROWS_MAX = 128
WINDOW_MAX = 16384
MODES = ("rowscan", "rowmatch")

#: Kernel launches since the last :func:`reset_launches`.  A wrapper adds
#: one where it launches its kernel, and nowhere else.
LAUNCHES = {"probe_row_gather": 0, "probe_lanemap": 0,
            "probe_window_gather": 0, "probe_sublane": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def row_gather_plain(idx: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Plain version of the depth probe: ``t[idx mod R, j]``."""
    i = idx.to(torch.int32) % t.shape[0]
    return t[i.long(), torch.arange(LANES, device=t.device)]


def lanemap_plain(st: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of lanemap: ``x[128*A[r, lo] + lo]``."""
    s = st.to(torch.int32)
    lo = s & 127
    a_at = torch.take_along_dim((s >> 8) & 127, lo.long(), dim=1)
    return x[(128 * a_at + lo).long()]


def window_gather_plain(idx: torch.Tensor, x: torch.Tensor,
                        mode: str) -> torch.Tensor:
    """Plain version of the window gather: ``x[idx]`` (``"rowscan"``) or
    ``x[128*(8*(idx>>10) + r mod 8) + (idx & 127)]`` (``"rowmatch"``)."""
    i = idx.to(torch.int32)
    if mode == "rowscan":
        return x[i.long()]
    r = torch.arange(i.shape[0], dtype=torch.int32, device=i.device) % 8
    return x[(128 * (8 * (i >> 10) + r[:, None]) + (i & 127)).long()]


def sublane_plain(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of sublane:
    ``x[128*(8*(hi>>3) + (hi[r, lo] & 7)) + lo]``."""
    i = idx.to(torch.int32)
    hi, lo = i >> 7, i & 127
    hi_at = torch.take_along_dim(hi, lo.long(), dim=1)
    return x[(128 * (8 * (hi >> 3) + (hi_at & 7)) + lo).long()]


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(name: str, t: torch.Tensor, dtype, device: torch.device,
           ok_shape: bool, shape: str, align: int = 1) -> None:
    """Device, dtype (one, or a tuple of those allowed), shape and
    contiguity, and the data pointer a multiple of ``align`` bytes."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected "
                        f"{' or '.join(map(str, dtypes))}")
    if not ok_shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape} tensor, "
                         f"got shape {tuple(t.shape)}")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _check_stream(idx: torch.Tensor, device: torch.device) -> None:
    _check("idx", idx, torch.uint16, device,
           idx.dim() == 2 and idx.shape[1] == LANES, "(nrows, 128)")


def _check_window(x: torch.Tensor) -> None:
    _check("x", x, torch.float32, x.device,
           x.dim() == 1 and 1 <= x.numel() <= WINDOW_MAX,
           f"(win,) with 1 <= win <= {WINDOW_MAX}")


def _launch(name: str, idx: torch.Tensor, table: torch.Tensor,
            *options) -> torch.Tensor:
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    if out.numel():
        fn = _build.load(name)
        with torch.cuda.device(idx.device):
            err = fn(idx.data_ptr(), table.data_ptr(), out.data_ptr(),
                     idx.shape[0], *options,
                     torch.cuda.current_stream(idx.device).cuda_stream)
        LAUNCHES[name] += 1
        if err != 0:
            raise RuntimeError(
                f"{name}: kernel launch failed with CUDA error {err}")
    return out


def row_gather(idx: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Depth probe: ``out[r,j] = t[idx[r,j] mod R, j]``.

    idx: (nrows, 128) u16; t: (R, 128) f32, 1 <= R <= 128.  Returns
    (nrows, 128) f32.
    """
    if _on_cpu(idx, t):
        return row_gather_plain(idx, t)
    _check("t", t, torch.float32, t.device,
           t.dim() == 2 and t.shape[1] == LANES
           and 1 <= t.shape[0] <= TABLE_ROWS_MAX,
           f"(R, 128) with 1 <= R <= {TABLE_ROWS_MAX}")
    _check_stream(idx, t.device)
    return _launch("probe_row_gather", idx, t, t.shape[0])


def lanemap(st: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Lanemap gather: ``out[r,j] = x[128*A[r, lo[r,j]] + lo[r,j]]`` with
    ``lo = st & 127`` and ``A = (st >> 8) & 127 < win/128``.

    st: (nrows, 128) u16; x: (win,) f32.  Returns (nrows, 128) f32.
    """
    if _on_cpu(st, x):
        return lanemap_plain(st, x)
    _check_window(x)
    _check_stream(st, x.device)
    return _launch("probe_lanemap", st, x, x.numel())


def window_gather(idx: torch.Tensor, x: torch.Tensor,
                  mode: str) -> torch.Tensor:
    """Window gather, ``mode="rowscan"`` (``x[idx]``) or ``"rowmatch"``
    (``x[128*(8*(idx>>10) + r mod 8) + (idx & 127)]``).

    idx: (nrows, 128) u16, idx < win; x: (win,) f32.  Returns
    (nrows, 128) f32.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be rowscan|rowmatch, got {mode!r}")
    if _on_cpu(idx, x):
        return window_gather_plain(idx, x, mode)
    _check_window(x)
    _check_stream(idx, x.device)
    return _launch("probe_window_gather", idx, x, x.numel(),
                   int(mode == "rowmatch"))


def sublane(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sublane-then-lane gather:
    ``out[r,j] = x[128*(8*(hi[r,j]>>3) + (hi[r, lo[r,j]] & 7)) + lo[r,j]]``
    with ``hi = idx >> 7`` and ``lo = idx & 127``.

    idx: (nrows, 128) u16, idx < win; x: (win,) f32.  Returns
    (nrows, 128) f32.
    """
    if _on_cpu(idx, x):
        return sublane_plain(idx, x)
    _check_window(x)
    _check_stream(idx, x.device)
    return _launch("probe_sublane", idx, x, x.numel())
