"""ctypes binding for the native section router (``edge_plan.cpp``).

The port's copy of ``graph_tpu.engine.native_route.build_sections_native``
with the section's row count a parameter: 512 (the TPU plan's sections)
or 128 (``scripts/perf_k2_sec128.py``'s).  It serves the K2 stage probes
only; the port's own plan routes nothing.  There is no fallback: the
Python router (:mod:`graph_tpu_torch.probes.route`) takes seconds a
section, so :func:`route_sections` raises when the library cannot be
built.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from graph_tpu_torch.native.build import try_load

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib, why = try_load("edge_plan.cpp")
        if lib is None:
            raise RuntimeError(f"native edge_plan unavailable: {why}")
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.gtt_route_sections.restype = ctypes.c_int
        lib.gtt_route_sections.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int,
            u16p, u16p, u16p, u16p, u16p, ctypes.c_int]
        _lib = lib
    return _lib


def route_sections(keys: np.ndarray, rows: int = 512,
                   nthreads: int = 0) -> tuple:
    """Route every section of ``keys`` ((nsec * rows * 128,) int32, each
    section's keys in [-1, rows * 128], the ends being pads) on
    ``nthreads`` threads (0: every CPU, at most 32).  Returns (wa, wb,
    sstart, wa2, wb2), each (nsec * rows, 128) u16; at ``rows=512`` what
    ``graph_tpu``'s native router gives."""
    if rows not in (128, 512):
        raise ValueError(f"rows must be 128 or 512, got {rows}")
    sec = rows * 128
    keys = np.ascontiguousarray(keys, np.int32)
    if keys.ndim != 1 or keys.size % sec:
        raise ValueError(f"keys must be 1-d, a multiple of {sec} long")
    if keys.size and (keys.min() < -1 or keys.max() > sec):
        raise ValueError(f"keys must lie in [-1, {sec}]")
    nsec = keys.size // sec
    outs = [np.empty((nsec * rows, 128), np.uint16) for _ in range(5)]
    if nthreads <= 0:
        nthreads = min(32, os.cpu_count() or 1)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    rc = _load().gtt_route_sections(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(nsec), ctypes.c_int(rows),
        *[o.ctypes.data_as(u16p) for o in outs], ctypes.c_int(nthreads))
    if rc != 0:
        raise RuntimeError(f"gtt_route_sections returned {rc}")
    return tuple(outs)
