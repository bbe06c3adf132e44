"""Lane maps of the lane-axis kernels, the Python side of ``csrc/lanes.cuh``.

A lane map names the rows of a lane-major ``(k', V)`` state that one
launch takes, in lane order.  It goes to the kernel by value, in the
launch's parameters, so a launch reads and writes the state's rows in
place and no index tensor is copied to the device.  A launch takes at
most :data:`MAX_LANES` lanes (k bits of a vertex fit one 32-bit frontier
word) and pads k up to one of the kernels' built widths
:data:`LANE_WIDTHS`; pad lanes read nothing and write nothing.
"""
from __future__ import annotations

import ctypes

MAX_LANES = 32
LANE_WIDTHS = (1, 4, 8, 32)


def lane_list(lanes, rows: int) -> list[int]:
    """The lane map as a list of distinct ints in ``[0, rows)``."""
    out = [int(i) for i in lanes]
    if len(set(out)) != len(out) or any(not 0 <= i < rows for i in out):
        raise ValueError(f"lanes: want distinct rows of the {rows}-lane "
                         f"state, got {out}")
    return out


def lane_chunks(lanes: list[int]):
    """``(lo, ctypes int array, k, K)`` for each launch of at most
    :data:`MAX_LANES` lanes: ``lanes[lo:lo + k]``, K the built width that
    covers k."""
    for lo in range(0, len(lanes), MAX_LANES):
        chunk = lanes[lo:lo + MAX_LANES]
        K = next(w for w in LANE_WIDTHS if w >= len(chunk))
        yield lo, (ctypes.c_int * len(chunk))(*chunk), len(chunk), K
