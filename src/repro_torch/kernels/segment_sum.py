"""Segment reduce over a stream sorted by segment: the CUDA kernel's
wrapper and its plain version.

Counterpart of ``repro.kernels.segment_sum``, the sparse path's companion
of ``edge_block``.  The TPU kernel streams ``(block_e,)`` tiles through
VMEM and keeps the whole ``(V/128, 128)`` output tile resident across its
sequential grid; on Hopper grid blocks run in no order, so
``csrc/segment_sum.cu`` cuts the stream into tiles of ``TILE`` elements
(256 threads × 8) instead and reduces it as a segmented reduction: a
block reduces its tile's runs with a block-wide segmented scan and writes
those that end inside it, the runs that cross a tile boundary leave
per-tile carries, and a second pass folds each such run's carries in tile
order.  A fill before them gives empty segments the identity.  The work
per block is balanced by elements, so R-MAT's hub no longer falls to one
thread, and there are no atomics: a float add is summed in an order fixed
by the tile shape, the same on every run, though not the plain version's.

:func:`segment_reduce` takes the plain version for tensors on the CPU
and launches the kernel for tensors on a CUDA device; it never falls back
from one to the other.  As in the JAX package, its one caller in the
port is ``ops.segment_reduce``: the sparse backend's pull sweep scatters
per chunk and does not use it.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import REDUCE_OPS, segment_reduce_ref

_VALUE_DTYPES = {torch.float32: 1, torch.int32: 0}
# Elements a tile of the kernel (csrc/segment_sum.cu's kTile): the carry
# scratch holds one entry a tile.
TILE = 256 * 8


def segment_reduce(seg: torch.Tensor, val: torch.Tensor, num_segments: int,
                   *, reduce: str = "add") -> torch.Tensor:
    """``(num_segments,)`` add/min/max of ``val`` per segment id.

    ``seg`` is ``(E,)`` int32 sorted ascending (the kernel does not
    check); ids ``>= num_segments`` (a padded tail) are dropped, and an
    empty segment holds the reduce identity.  Min and max propagate NaN.
    The kernel adds a float segment in its tiles' order (a thread's 8
    elements, the block scan's tree, then the carries of a run that
    crosses tiles in tile order); the plain version adds in
    ``scatter_reduce_``'s order.
    """
    if reduce not in REDUCE_OPS:
        raise ValueError(f"not a menu reduce: {reduce!r}")
    if val.device.type in ("cpu", "meta"):
        # meta: the result's shape and dtype only; nothing runs
        return segment_reduce_ref(seg, val, num_segments, reduce=reduce)
    if val.device.type != "cuda":
        raise ValueError(f"segment_reduce runs on CPU or CUDA tensors, "
                         f"got {val.device}")
    if val.dtype not in _VALUE_DTYPES:
        raise TypeError(f"the kernel takes int32 or float32 values, "
                        f"got {val.dtype}")
    E = seg.shape[0]
    for name, t, dtype in (("seg", seg, torch.int32),
                           ("val", val, val.dtype)):
        if t.device != val.device or t.dtype != dtype \
                or tuple(t.shape) != (E,) or not t.is_contiguous():
            raise ValueError(
                f"{name}: want a contiguous {dtype} tensor of shape ({E},) "
                f"on {val.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    out = torch.empty((num_segments,), dtype=val.dtype, device=val.device)
    if num_segments == 0:
        return out
    # per tile: first and last run's partial (4 bytes each), flags
    tiles = -(-E // TILE)
    carries = torch.empty((3, max(tiles, 1)), dtype=torch.int32,
                          device=val.device)
    lib = _build.library("segment_sum")
    stream = torch.cuda.current_stream(val.device).cuda_stream
    err = lib.segment_reduce_launch(
        val.device.index or 0, REDUCE_OPS.index(reduce),
        _VALUE_DTYPES[val.dtype], seg.data_ptr(), val.data_ptr(),
        out.data_ptr(), carries[0].data_ptr(), carries[1].data_ptr(),
        carries[2].data_ptr(), tiles, E, num_segments, stream)
    if err != 0:
        raise RuntimeError(f"segment_reduce kernel launch failed: "
                           f"cudaError_t {err}")
    segment_reduce.launches += 1
    return out


# launches of the CUDA kernel since the count was last set to 0
segment_reduce.launches = 0
