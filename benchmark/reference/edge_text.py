"""Edge-list text in plain PyTorch: the bytes of an LDBC ``.e`` file (or
an unweighted ``.el`` one) to int64 ``(src, dst)``, by digit arithmetic.

A line holds two ids in decimal, separated by spaces or tabs, and ends
in LF; a CR before it counts as a separator, and blank lines hold no
edge.  Any other byte, or a line with other than two ids, is an error.
It imports nothing of the port.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: The bytes a file may hold beside digits: space, tab, CR, LF.
SEPARATORS = (32, 9, 13, 10)


def parse(data: bytes) -> Tuple[torch.Tensor, torch.Tensor]:
    """The edges of ``data``, in the order of its lines."""
    if not data:
        empty = torch.zeros(0, dtype=torch.int64)
        return empty, empty.clone()
    b = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(torch.int64)
    digit = (b >= 48) & (b <= 57)
    allowed = digit.clone()
    for sep in SEPARATORS:
        allowed |= b == sep
    if not bool(allowed.all()):
        at = int(torch.nonzero(~allowed)[0])
        raise ValueError(f"byte {int(b[at])} at offset {at} is no digit "
                         "or separator")
    before = torch.cat([digit.new_zeros(1), digit[:-1]])
    after = torch.cat([digit[1:], digit.new_zeros(1)])
    starts = torch.nonzero(digit & ~before).flatten()
    ends = torch.nonzero(digit & ~after).flatten()
    # each digit's number, and its power of ten within that number
    number = torch.cumsum((digit & ~before).to(torch.int64), 0) - 1
    at = torch.nonzero(digit).flatten()
    power = ends[number[at]] - at
    value = torch.zeros(starts.numel(), dtype=torch.int64)
    value.index_add_(0, number[at], (b[at] - 48) * 10 ** power)
    # every line that holds a number holds two
    line = torch.cumsum((b == 10).to(torch.int64), 0)[starts]
    _, per_line = torch.unique_consecutive(line, return_counts=True)
    if not bool((per_line == 2).all()):
        bad = int(line[torch.repeat_interleave(per_line != 2, per_line)][0])
        raise ValueError(f"line {bad + 1} holds other than two ids")
    return value[0::2].clone(), value[1::2].clone()
