"""The numbers that decide ``correct``: each answer of the program held
against the plain reference's answer to the same request.

One function per kind of answer; each returns its numbers by name.  A
configuration's ``limits`` say which of them are compared and at what
limit; the others are printed by ``benchmark/calibrate.py`` only.
"""

from __future__ import annotations

import numpy as np

#: The highest-ranked nodes of the reference that ``top_rel`` looks at.
TOP = 1000
#: The program's mark of an unreached node (the reference crate's f32::MAX).
UNREACHED = float(np.finfo(np.float32).max)


def page_rank(answer: np.ndarray, ref: np.ndarray) -> dict:
    """``l1_rel``: the L1 distance over the reference's L1 norm;
    ``max_rel``: the largest relative error of a node; ``top_rel``: the
    largest relative error among the reference's ``TOP`` highest."""
    a = np.asarray(answer, dtype=np.float64)
    r = np.asarray(ref, dtype=np.float64)
    if a.shape != r.shape:
        return {"l1_rel": float("inf"), "max_rel": float("inf"),
                "top_rel": float("inf")}
    diff = np.abs(a - r)
    rel = diff / np.abs(r)
    top = np.argpartition(-r, min(TOP, r.size) - 1)[:TOP]
    return {"l1_rel": float(diff.sum() / np.abs(r).sum()),
            "max_rel": float(np.nan_to_num(rel, nan=np.inf).max()),
            "top_rel": float(np.nan_to_num(rel[top], nan=np.inf).max())}


def wcc(answer: np.ndarray, ref: np.ndarray) -> dict:
    """``mismatched``: nodes whose label is not the least id of their
    component."""
    a = np.asarray(answer).astype(np.int64)
    r = np.asarray(ref).astype(np.int64)
    if a.shape != r.shape:
        return {"mismatched": float(max(a.size, r.size))}
    return {"mismatched": float(np.count_nonzero(a != r))}


def sssp(answer: np.ndarray, ref: np.ndarray) -> dict:
    """``rel_err``: the largest relative error of a distance; a node
    reached on one side only, or a wrong distance to the source, reads
    infinite."""
    a = np.asarray(answer, dtype=np.float64)
    r = np.asarray(ref, dtype=np.float64)
    if a.shape != r.shape:
        return {"rel_err": float("inf")}
    a_unreached = ~(a < UNREACHED)  # NaN counts as unreached
    r_unreached = np.isinf(r)
    if np.any(a_unreached != r_unreached):
        return {"rel_err": float("inf")}
    both = ~r_unreached
    diff = np.abs(a[both] - r[both])
    scale = np.abs(r[both])
    if np.any((scale == 0) & (diff > 0)):
        return {"rel_err": float("inf")}
    rel = np.divide(diff, scale, out=np.zeros_like(diff), where=scale > 0)
    return {"rel_err": float(rel.max(initial=0.0))}


KINDS = {"page_rank": page_rank, "wcc": wcc, "sssp": sssp}
