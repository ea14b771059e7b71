"""ctypes binding for the native multithreaded edge-list parser.

Counterpart of ``graph_tpu.native.edge_list_parser`` (reference analog:
the mmap+threads parser in crates/builder/src/input/edgelist.rs); the C++
is the port's own copy, ``native/edgelist_parser.cpp``.  When the library
cannot be built, :func:`parse` returns None and :func:`load_error` says
why, so that callers fall back to another parser and can report it.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Optional, Tuple

import numpy as np

from graph_tpu_torch.native.build import try_load

log = logging.getLogger(__name__)

_lib = None
_error: Optional[str] = None


class _GtEdgeList(ctypes.Structure):
    _fields_ = [
        ("src", ctypes.POINTER(ctypes.c_int64)),
        ("dst", ctypes.POINTER(ctypes.c_int64)),
        ("val", ctypes.POINTER(ctypes.c_float)),
        ("count", ctypes.c_int64),
    ]


def _load():
    global _lib, _error
    if _lib is None and _error is None:
        _lib, _error = try_load("edgelist_parser.cpp")
        if _lib is None:
            log.debug("native edge-list parser unavailable: %s", _error)
        else:
            _lib.gt_parse_edge_list.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(_GtEdgeList)]
            _lib.gt_parse_edge_list.restype = ctypes.c_int
            _lib.gt_free_edge_list.argtypes = [ctypes.POINTER(_GtEdgeList)]
            _lib.gt_free_edge_list.restype = None
            _lib.gt_edge_list_threads.argtypes = [ctypes.c_int64]
            _lib.gt_edge_list_threads.restype = ctypes.c_int
    return _lib


def load_error() -> Optional[str]:
    """Why the native parser could not be built or loaded; None if it
    loaded or has not been tried."""
    return _error


def threads(size: int) -> Optional[int]:
    """The threads :func:`parse` splits a file of ``size`` bytes over;
    None if the library is unavailable."""
    lib = _load()
    return None if lib is None else int(lib.gt_edge_list_threads(size))


def parse(
    path: str, weighted: bool
) -> Optional[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]]:
    """Parse with the native library; None if unavailable (use fallback)."""
    lib = _load()
    if lib is None:
        return None
    res = _GtEdgeList()
    rc = lib.gt_parse_edge_list(str(path).encode(), int(weighted),
                                ctypes.byref(res))
    if rc != 0:
        if rc == 1:
            raise FileNotFoundError(path)
        raise MemoryError(f"native edge-list parse failed with code {rc}")
    try:
        n = res.count
        if n == 0:
            empty = np.zeros(0, dtype=np.int64)
            return (empty, empty.copy(),
                    np.zeros(0, np.float32) if weighted else None)
        src = np.ctypeslib.as_array(res.src, shape=(n,)).copy()
        dst = np.ctypeslib.as_array(res.dst, shape=(n,)).copy()
        val = (np.ctypeslib.as_array(res.val, shape=(n,)).copy()
               if weighted else None)
        return src, dst, val
    finally:
        lib.gt_free_edge_list(ctypes.byref(res))
