"""ctypes binding for the native host-CSR builder and the triangle-count
orientation.

Counterpart of ``graph_tpu.native.host_csr`` (``build_undirected_native``,
``tc_orient_native``); the C++ is the port's own copy,
``native/host_csr.cpp``.  Each returns None when the library cannot be
built; callers then use the numpy paths, which give the same results, and
:func:`load_error` says why.  The triangle count itself orients on its
device (:mod:`graph_tpu_torch.algos.triangle_count`); the tests hold
``tc_orient_native`` and that orientation against ``graph_tpu``'s.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Optional

import numpy as np

from graph_tpu_torch.native.build import try_load

log = logging.getLogger(__name__)

_lib = None
_error: Optional[str] = None


class _GtHostCsr(ctypes.Structure):
    _fields_ = [
        ("m_out", ctypes.c_int64),
        ("offsets", ctypes.POINTER(ctypes.c_int32)),
        ("rows", ctypes.POINTER(ctypes.c_int32)),
        ("cols", ctypes.POINTER(ctypes.c_int32)),
        ("vals", ctypes.POINTER(ctypes.c_float)),
    ]


def _load():
    global _lib, _error
    if _lib is None and _error is None:
        _lib, _error = try_load("host_csr.cpp")
        if _lib is None:
            log.warning("native host_csr unavailable (%s); numpy fallback",
                        _error)
        else:
            _lib.gt_build_undirected.restype = ctypes.POINTER(_GtHostCsr)
            _lib.gt_build_undirected.argtypes = [
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int]
            _lib.gt_host_csr_free.argtypes = [ctypes.POINTER(_GtHostCsr)]
            _lib.gt_host_csr_free.restype = None
            i32p = ctypes.POINTER(ctypes.c_int32)
            _lib.gt_tc_orient.restype = ctypes.c_int64
            _lib.gt_tc_orient.argtypes = [i32p, i32p, ctypes.c_int64,
                                          ctypes.c_int64, i32p, i32p]
    return _lib


def load_error() -> Optional[str]:
    """Why the native builder could not be built or loaded; None if it
    loaded or has not been tried."""
    return _error


def build_undirected_native(src, dst, values, n: int, layout_code: int):
    """Both directions of (src, dst) as one CSR, sorted by row (stably;
    layout 0) or by (row, col) (layout 1; layout 2 also drops duplicates
    and self-loops).  Returns (offsets, rows, cols, vals) as int32/f32
    numpy arrays, or None without the library."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src {src.shape} and dst {dst.shape} must be "
                         "1-d of one length")
    vptr = None
    if values is not None:
        values = np.ascontiguousarray(values, np.float32)
        if values.shape != src.shape:
            raise ValueError(f"values {values.shape} != src {src.shape}")
        vptr = values.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    out_p = lib.gt_build_undirected(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vptr, ctypes.c_int64(src.size), ctypes.c_int64(n),
        ctypes.c_int(layout_code))
    try:
        out = out_p.contents
        k = int(out.m_out)
        offsets = np.ctypeslib.as_array(out.offsets, (n + 1,)).copy()
        rows = (np.ctypeslib.as_array(out.rows, (k,)).copy() if k
                else np.zeros(0, np.int32))
        cols = (np.ctypeslib.as_array(out.cols, (k,)).copy() if k
                else np.zeros(0, np.int32))
        vals = None
        if values is not None:
            vals = (np.ctypeslib.as_array(out.vals, (k,)).copy() if k
                    else np.zeros(0, np.float32))
    finally:
        lib.gt_host_csr_free(out_p)
    return offsets, rows, cols, vals



def tc_orient_native(srcs, tgts, n: int):
    """Triangle-count orientation: rank nodes by ascending degree (ties by
    id), keep the edges whose source ranks below their target, sorted by
    (rank(src), rank(dst)).  srcs, tgts: (m,) ids below ``n`` (both
    directions of each undirected edge).  Returns (a, b) int32 numpy
    arrays of the forward edges' ranks, or None without the library."""
    lib = _load()
    if lib is None:
        return None
    srcs = np.ascontiguousarray(srcs, np.int32)
    tgts = np.ascontiguousarray(tgts, np.int32)
    if srcs.shape != tgts.shape or srcs.ndim != 1:
        raise ValueError(f"srcs {srcs.shape} and tgts {tgts.shape} must be "
                         "1-d of one length")
    if srcs.size and (min(srcs.min(), tgts.min()) < 0
                      or max(srcs.max(), tgts.max()) >= n):
        raise ValueError(f"edge endpoints must lie in [0, {n})")
    m = srcs.size
    a = np.empty(m, np.int32)
    b = np.empty(m, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    mf = lib.gt_tc_orient(srcs.ctypes.data_as(i32p),
                          tgts.ctypes.data_as(i32p), ctypes.c_int64(m),
                          ctypes.c_int64(n), a.ctypes.data_as(i32p),
                          b.ctypes.data_as(i32p))
    return a[:mf].copy(), b[:mf].copy()
