"""Binary graph snapshots (checkpoint / resume).

Counterpart of ``graph_tpu.io.binary`` (reference analog: type-name-tagged
raw-bytes CSR dump/load, crates/builder/src/graph/csr.rs:247-314, plus
``BinaryInput``, crates/builder/src/input/binary.rs:13-38).  The format is
``graph_tpu``'s, byte for byte, so a snapshot written by either package
loads in the other (little-endian):

    magic  b"GTPU1\\n"
    u32    id dtype name length, then name bytes (numpy's, e.g. b"int32")
    u8     graph kind: 0=directed, 1=undirected
    u8     has edge values, u8 has node values, u8 layout code
           (UNSORTED 0, SORTED 1, DEDUPLICATED 2)
    u64    node_count, u64 edge array length (per direction)
    raw    offsets/targets arrays (+ f32 values) per CSR
    u32    node-value itemsize, then the node values as f32 (if present)

``sources`` is not stored; it is re-expanded from offsets on load.  A
mismatched id dtype raises :class:`InvalidIdType` (csr.rs:285-290).
"""

from __future__ import annotations

import struct
from typing import Union

import numpy as np
import torch

from graph_tpu_torch.device import resolve_device
from graph_tpu_torch.errors import GraphError, InvalidIdType
from graph_tpu_torch.graph.build import LAYOUT_CODES
from graph_tpu_torch.graph.csr import (
    Csr, DirectedCsrGraph, UndirectedCsrGraph)

MAGIC = b"GTPU1\n"
_LAYOUTS = {code: layout for layout, code in LAYOUT_CODES.items()}


def _np(t):
    return None if t is None else t.cpu().numpy()


def save_graph(path: str,
               graph: Union[DirectedCsrGraph, UndirectedCsrGraph]) -> None:
    """Write a binary snapshot (csr.rs:252-282 ``serialize`` analog).

    >>> import os, tempfile
    >>> from graph_tpu_torch.graph.build import build_directed
    >>> g = build_directed([0, 1, 2], [1, 2, 0], node_count=3, device="cpu")
    >>> path = os.path.join(tempfile.mkdtemp(), "g.bin")
    >>> save_graph(path, g)
    >>> g2 = load_graph(path, device="cpu")
    >>> (g2.node_count, g2.edge_count)
    (3, 3)
    """
    directed = isinstance(graph, DirectedCsrGraph)
    csrs = [graph.csr_out, graph.csr_in] if directed else [graph.csr]
    targets0 = _np(csrs[0].targets)
    id_name = targets0.dtype.name.encode()
    nv = _np(graph.node_values)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(id_name)))
        f.write(id_name)
        f.write(struct.pack("<BBBB", 0 if directed else 1,
                            csrs[0].values is not None, nv is not None,
                            LAYOUT_CODES[graph.layout]))
        f.write(struct.pack("<QQ", csrs[0].node_count, targets0.shape[0]))
        for csr in csrs:
            f.write(_np(csr.offsets).tobytes())
            f.write(_np(csr.targets).tobytes())
            if csr.values is not None:
                f.write(_np(csr.values).astype(np.float32).tobytes())
        if nv is not None:
            f.write(struct.pack("<I", nv.dtype.itemsize))
            f.write(nv.astype(np.float32).tobytes())


def load_graph(path: str, id_dtype=np.int32, device=None):
    """Load a snapshot onto ``device``; raises :class:`InvalidIdType` when
    the file's id dtype is not ``id_dtype``."""
    device = resolve_device(device)
    expected = np.dtype(id_dtype)
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise GraphError(f"{path}: not a graph_tpu snapshot")
        (name_len,) = struct.unpack("<I", f.read(4))
        id_name = f.read(name_len).decode()
        if id_name != expected.name:
            raise InvalidIdType(expected=expected.name, actual=id_name)
        dt = np.dtype(id_name)
        kind, has_values, has_nv, layout_code = struct.unpack(
            "<BBBB", f.read(4))
        n, m = struct.unpack("<QQ", f.read(16))

        def read(dtype, count):
            a = np.fromfile(f, dtype=dtype, count=count)
            if a.size != count:
                raise GraphError(f"{path}: truncated snapshot")
            return torch.from_numpy(a).to(device)

        def read_csr():
            offsets = read(dt, n + 1)
            targets = read(dt, m)
            values = read(np.float32, m) if has_values else None
            sources = torch.repeat_interleave(
                torch.arange(n, dtype=offsets.dtype, device=device),
                torch.diff(offsets).long(), output_size=m)
            return Csr(offsets=offsets, sources=sources, targets=targets,
                       values=values)

        csrs = [read_csr() for _ in range(2 if kind == 0 else 1)]
        nv = None
        if has_nv:
            f.read(4)  # the writer's node-value itemsize; stored as f32
            nv = read(np.float32, n)
    layout = _LAYOUTS[layout_code]
    if kind == 0:
        return DirectedCsrGraph(csr_out=csrs[0], csr_in=csrs[1],
                                node_values=nv, layout=layout)
    return UndirectedCsrGraph(csr=csrs[0], node_values=nv, layout=layout)


class BinaryInput:
    """``BinaryInput`` analog (input/binary.rs:13-38) for the builder.

    A snapshot already holds a whole graph (the reference's ``GraphInput``
    for binary is the graph itself, input/binary.rs:21-28), so it plugs
    into the builder through ``read_graph``::

        GraphBuilder().file_format(BinaryInput()).path(p).build_directed()

    Raises :class:`InvalidIdType` when the snapshot's id dtype does not
    match the builder's (csr.rs:285-290 parity).
    """

    def __init__(self, id_dtype=None):
        self.id_dtype = id_dtype

    def read_graph(self, path: str, id_dtype=np.int32, device=None):
        return load_graph(path, self.id_dtype if self.id_dtype is not None
                          else id_dtype, device=device)
