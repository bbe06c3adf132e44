"""Lane maps of the lane-axis kernels, the Python side of ``csrc/lanes.cuh``.

A lane map names the rows of a lane-major ``(k', V)`` state that one
launch takes, in lane order.  It goes to the kernel by value, in the
launch's parameters, so a launch reads and writes the state's rows in
place and no index tensor is copied to the device.  A launch takes at
most :data:`MAX_LANES` lanes (k bits of a vertex fit one 32-bit frontier
word) and pads k up to one of the kernels' built widths
:data:`LANE_WIDTHS`; pad lanes read nothing and write nothing.

:class:`Prepared` holds the tables of the kernels' pre-pass for one
state (``lanes_pack_kernel``; kernel 1's ``edge_block_pack_kernel`` is
its K = 1 case): per launch, the K-bit frontier words and the
vertex-major message table.  They depend on the state only, so a caller
that sweeps one state over many edge blocks (the streamed engine's
partitions) runs the pre-pass once and hands the tables to each launch
(``prepared=``).  The plain versions compute from the state and only
check that the tables are for it, so on the CPU a :class:`Prepared`
holds no tables.
"""
from __future__ import annotations

import ctypes
import typing

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


class Prepared(typing.NamedTuple):
    """The pre-pass's tables for one state: ``lanes`` (the swept rows of
    the ``(k', V)`` state, or ``(0,)`` for kernel 1's one lane), and per
    launch ``(lo, lane_map, k, K, bits, msg)``: ``bits`` the int32 words
    of the K-bit frontier (``None`` without ``mask_inactive``), ``msg`` the
    ``(V * K,)`` vertex-major messages (``None`` where the kernel reads the
    values themselves).  ``chunks`` is empty for CPU tensors."""

    lanes: tuple
    gather: str
    mask_inactive: bool
    chunks: tuple


def check_prepared(prepared, lanes, gather: str, mask_inactive) -> None:
    """Raise unless ``prepared`` (or None) holds the tables of these very
    lanes, gather and mask."""
    if prepared is None:
        return
    if tuple(prepared.lanes) != tuple(lanes) \
            or prepared.gather != gather \
            or prepared.mask_inactive != bool(mask_inactive):
        raise ValueError(f"prepared tables are for lanes "
                         f"{list(prepared.lanes)}, gather "
                         f"{prepared.gather!r}, mask_inactive "
                         f"{prepared.mask_inactive}; this call wants "
                         f"{list(lanes)}, {gather!r}, {bool(mask_inactive)}")
