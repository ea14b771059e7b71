"""An edge list written as LDBC Graphalytics ``.e`` text, formatted on
the edges' device: ``"src dst\\n"`` a line, in the order given, ids in
decimal without leading zeros.

:func:`write` puts the file into a fresh temporary directory in LDBC's
unpacked layout (``graph-500-<scale>/graph500-<scale>.e``) and flushes
it to its file system, so that no writeback of it runs after set-up; the
pages stay in the host's cache.  The directory is removed when the
returned :class:`TextFile` is collected, or at exit.
"""

from __future__ import annotations

import os
import tempfile

import torch

#: Edges formatted a step: about 64 MB of text at scale 22.
STEP = 1 << 22


class TextFile:
    """The file's path; holds its directory."""

    def __init__(self, path: str, directory: tempfile.TemporaryDirectory):
        self.path, self._dir = path, directory


def lines(src: torch.Tensor, dst: torch.Tensor, width: int) -> torch.Tensor:
    """``"src dst\\n"`` for each edge as uint8 bytes, on the edges'
    device: ``width`` digits an id, then the leading zeros dropped."""
    dev = src.device
    pow10 = 10 ** torch.arange(width - 1, -1, -1, device=dev)
    chars = torch.empty((src.numel(), 2 * width + 2), dtype=torch.uint8,
                        device=dev)
    keep = torch.ones(chars.shape, dtype=torch.bool, device=dev)
    for col, v in ((0, src), (width + 1, dst)):
        digits = v[:, None] // pow10
        chars[:, col:col + width] = 48 + digits % 10
        keep[:, col:col + width - 1] = digits[:, :-1] > 0
    chars[:, width] = 32
    chars[:, -1] = 10
    return chars[keep]


def write(src: torch.Tensor, dst: torch.Tensor, scale: int) -> TextFile:
    """The edges as ``graph500-<scale>.e`` in a new temporary directory."""
    tmp = tempfile.TemporaryDirectory(prefix="ldbc-")
    path = os.path.join(tmp.name, f"graph-500-{scale}",
                        f"graph500-{scale}.e")
    os.makedirs(os.path.dirname(path))
    w = len(str(int(torch.maximum(src.max(), dst.max())))) if len(src) else 1
    with open(path, "wb") as f:
        for lo in range(0, src.numel(), STEP):
            text = lines(src[lo:lo + STEP], dst[lo:lo + STEP], w)
            text.cpu().numpy().tofile(f)
        f.flush()
        os.fsync(f.fileno())
    return TextFile(path, tmp)
