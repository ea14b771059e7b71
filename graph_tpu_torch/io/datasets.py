"""LDBC Graphalytics dataset loader (local-path, checksummed).

Counterpart of ``graph_tpu.io.datasets`` (reference analog: the criterion
benches download Graph500 edge lists, scales 22-30, from the LDBC
Graphalytics mirror and parse the ``graph500-<scale>.e`` file,
crates/builder/benches/common/mod.rs:15-41).  This loader fetches
nothing: it finds datasets placed in ``$GRAPH_TPU_TORCH_DATASETS``
(default: ``.cache/datasets`` in the repository, which git ignores),
checks them against an optional ``.sha256`` sidecar and parses them with
the builder's edge-list pipeline.

Layout expected per dataset (LDBC Graphalytics unpacked form)::

    <datasets>/graph-500-22/graph500-22.e        # "src dst" per line
    <datasets>/graph-500-22/graph500-22.e.sha256 # optional checksum
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

from graph_tpu_torch.errors import GraphError

#: The reference's bench range (benches/common/mod.rs:25 "Available scale
#: factors are 22..=30").  Checksums are per-file sidecars (``.sha256``)
#: because LDBC does not publish stable digests for the unpacked .e files.
GRAPH500_SCALES = range(22, 31)

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".cache", "datasets")


def dataset_dir() -> str:
    return os.environ.get("GRAPH_TPU_TORCH_DATASETS", _DEFAULT_DIR)


def graph500_path(scale: int, datasets: Optional[str] = None) -> str:
    """Path of the ``graph500-<scale>.e`` edge file (reference naming,
    benches/common/mod.rs:40).  Raises if absent, with a message that
    says where the file goes; nothing is fetched."""
    root = datasets or dataset_dir()
    path = os.path.join(root, f"graph-500-{scale}", f"graph500-{scale}.e")
    if not os.path.exists(path):
        raise GraphError(
            f"dataset graph500-{scale} not found at {path}; download "
            f"graph500-{scale}.tar.zst from the LDBC Graphalytics mirror "
            "and unpack the .e file there (or set $GRAPH_TPU_TORCH_DATASETS "
            "to the directory that holds graph-500-<scale>/); this loader "
            "does not fetch it")
    _verify_checksum(path)
    return path


def _verify_checksum(path: str) -> None:
    """Check ``<path>.sha256`` if present (hex digest, first token)."""
    sidecar = path + ".sha256"
    if not os.path.exists(sidecar):
        return
    with open(sidecar) as f:
        expected = f.read().split()[0].strip().lower()
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    if h.hexdigest() != expected:
        raise GraphError(
            f"checksum mismatch for {path}: expected {expected}, "
            f"got {h.hexdigest()} — re-download the dataset")


def load_graph500(scale: int, datasets: Optional[str] = None,
                  directed: bool = False, device=None):
    """Build the Graph500 graph from a local LDBC dataset on ``device``.

    Undirected by default: Graphalytics Graph500 is an undirected
    benchmark graph (the reference's TC/bench usage).
    """
    from graph_tpu_torch.builder import GraphBuilder

    b = GraphBuilder(device=device).path(graph500_path(scale, datasets))
    return b.build_directed() if directed else b.build_undirected()
