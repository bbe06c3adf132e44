"""Dense ELL gather-apply-reduce: the CUDA kernel's wrapper and its plain
version.

Counterpart of ``repro.kernels.edge_block``.  The TPU kernel there keeps
the vertex tables as ``(V/128, 128)`` VMEM tiles and streams
``(block_rows, W)`` edge tiles; on Hopper the tables live in device memory
(the random reads hit L2), so ``csrc/edge_block.cu`` first builds, in
scratch this wrapper allocates, the frontier as a bitmap (under
``mask_inactive``) and the gather's message a vertex (for ``plus_one`` and
``div_deg``), and then runs one thread per row, a bit and a message read
a live slot; the TPU tiling has no counterpart here.  With ``block_live=``
the wrapper launches the per-block early-out variant (the TPU's
``_kernel_skip``), which the block-skipping pull plane runs: rows come in
blocks of ``block_rows``, and a dead block writes the identity without
gathering.  The two variants count their launches apart.

:func:`edge_block_reduce_lanes` is the lane-axis variant, the counterpart
of the Pallas kernel under ``jax.vmap`` in the JAX package's batched runs:
k value tables and frontiers over one graph, rows of a ``(k', V)`` state
named by a lane map (``lanes.py``), through one launch that reads each
row's ids once for all k lanes.  Its pre-pass lays
the lanes out vertex-major, the k messages of a vertex in one row (one
32-byte sector for k = 8) and its k frontier bits together, so a live
slot costs one sector however many lanes are live there.  It writes
``(k, R)`` sub-row partials, which the caller folds into vertices; the
translator keeps it for float add, whose fold has an order.  It counts
its launches apart too (``lane_launches``).

:func:`edge_block_fold_lanes` is the lane sweep with the sub-row fold
fused in, for the order-free reduces (min, max, int32 add): from the flat
pull view and its ``owner8`` straight to ``(k', V)`` reduced and got
tables, with no ``(k, R8)`` array and no ``subrow_combine``, and writes
the same rows of its tables.  Count: ``launches``.  Both lane kernels
read the lanes they sweep in place, through a lane map that goes to the
kernel by value (no index tensor is copied to the device).

The wrappers take the plain version for tensors on the CPU and launch the
kernel for tensors on a CUDA device; they never fall back from one to the
other.
"""
from __future__ import annotations

import torch

from . import _build
from .lanes import lane_chunks, lane_list
from .pull_bitmap import subrow_combine
from .ref import (GATHER_OPS, REDUCE_OPS, _identity, edge_block_messages,
                  edge_block_reduce_ref, row_reduce, settle_zero_ties,
                  zero_wins)

_VALUE_DTYPES = {torch.float32: 1, torch.int32: 0}
_FLAG_DTYPES = (torch.bool, torch.int8, torch.uint8)
# gathers whose per-vertex message the kernel's pre-pass tabulates
_MESSAGE_TABLE = ("plus_one", "div_deg")


def edge_block_reduce_plain(nbr, wgt, values, degrees, active, *, gather: str,
                            reduce: str, mask_inactive: bool = True,
                            block_live=None, block_rows: int | None = None):
    """Plain PyTorch version of the kernel (the oracle it is held to).

    With ``block_live``, the full sweep's rows of every dead block are
    overwritten with the identity and ``any=False``: what the early-out
    kernel computes, also where a caller marks a live block dead.
    """
    red, any_live = edge_block_reduce_ref(nbr, wgt, values, degrees, active,
                                          gather=gather, reduce=reduce,
                                          mask_inactive=mask_inactive)
    if block_live is None:
        return red, any_live
    R = nbr.shape[0]
    dead = (block_live == 0).repeat_interleave(block_rows)[:R]
    return (torch.where(dead, _identity(reduce, red.dtype), red),
            any_live & ~dead)


def edge_block_reduce(
    nbr: torch.Tensor,        # (R, W) int32 neighbor ids, PAD-padded
    wgt: torch.Tensor,        # (R, W) float32 edge weights
    values: torch.Tensor,     # (V,) int32 | float32 vertex values
    degrees: torch.Tensor,    # (V,) int32 out-degrees
    active: torch.Tensor,     # (V,) bool frontier
    *,
    gather: str,
    reduce: str,
    mask_inactive: bool = True,
    block_live: torch.Tensor | None = None,  # (ceil(R/block_rows),) flags
    block_rows: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row reduce of the menu gather over live slots.

    Returns ``(reduced (R,) values.dtype, any_live (R,) bool)``.  Neighbor
    ids must be ``PAD`` or lie in ``[0, V)`` (the layout builders
    guarantee it; the kernel does not re-check per call).  ``block_live``
    (bool, int8 or uint8; nonzero is live) with ``block_rows`` selects the
    early-out variant: the rows of a dead block hold the identity and
    ``any=False``.  Callers pass a conservative liveness to get the full
    sweep's result.
    """
    if block_live is not None:
        if block_rows is None or block_rows < 1:
            raise ValueError("block_live needs block_rows >= 1")
        nb = -(-nbr.shape[0] // block_rows)
        if tuple(block_live.shape) != (nb,) or \
                block_live.dtype not in _FLAG_DTYPES or \
                block_live.device != values.device or \
                not block_live.is_contiguous():
            raise ValueError(
                f"block_live: want a contiguous ({nb},) bool/int8/uint8 "
                f"tensor on {values.device}, got {block_live.dtype} "
                f"{tuple(block_live.shape)} on {block_live.device}")
    if gather not in GATHER_OPS or reduce not in REDUCE_OPS:
        raise ValueError(f"not a menu module: gather={gather!r}, "
                         f"reduce={reduce!r}")
    if gather == "div_deg" and not values.dtype.is_floating_point:
        raise ValueError("div_deg is a true division: it needs float values")
    if values.device.type == "cpu":
        return edge_block_reduce_plain(nbr, wgt, values, degrees, active,
                                       gather=gather, reduce=reduce,
                                       mask_inactive=mask_inactive,
                                       block_live=block_live,
                                       block_rows=block_rows)
    if values.device.type != "cuda":
        raise ValueError(f"edge_block_reduce runs on CPU or CUDA tensors, "
                         f"got {values.device}")
    if values.dtype not in _VALUE_DTYPES:
        raise TypeError(f"the kernel takes int32 or float32 values, "
                        f"got {values.dtype}")
    R, W = nbr.shape
    V = values.shape[0]
    want = {"nbr": (nbr, torch.int32, (R, W)),
            "wgt": (wgt, torch.float32, (R, W)),
            "values": (values, values.dtype, (V,)),
            "degrees": (degrees, torch.int32, (V,)),
            "active": (active, torch.bool, (V,))}
    for name, (t, dtype, shape) in want.items():
        if t.device != values.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want a contiguous {dtype} tensor of shape {shape} "
                f"on {values.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    out = torch.empty((R,), dtype=values.dtype, device=values.device)
    any_live = torch.empty((R,), dtype=torch.uint8, device=values.device)
    if R == 0:
        return out, any_live.view(torch.bool)
    # the pre-pass's frontier bits and messages
    bits = torch.empty((-(-V // 32),), dtype=torch.int32,
                       device=values.device) if mask_inactive else None
    msg = torch.empty_like(values) if gather in _MESSAGE_TABLE else None
    lib = _build.library("edge_block")
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = lib.edge_block_reduce_launch(
        values.device.index or 0, GATHER_OPS.index(gather),
        REDUCE_OPS.index(reduce), _VALUE_DTYPES[values.dtype],
        int(mask_inactive),
        block_live.data_ptr() if block_live is not None else None,
        block_rows or 0, nbr.data_ptr(), wgt.data_ptr(),
        values.data_ptr(), degrees.data_ptr(), active.data_ptr(),
        None if bits is None else bits.data_ptr(),
        None if msg is None else msg.data_ptr(), V, out.data_ptr(),
        any_live.data_ptr(), R, W, stream)
    if err != 0:
        raise RuntimeError(f"edge_block kernel launch failed: "
                           f"cudaError_t {err}")
    if block_live is None:
        edge_block_reduce.launches += 1
    else:
        edge_block_reduce.skip_launches += 1
    return out, any_live.view(torch.bool)


# launches since the counts were last set to 0: of the full-sweep kernel,
# and of its block-skipping variant
edge_block_reduce.launches = 0
edge_block_reduce.skip_launches = 0


def edge_block_reduce_lanes_plain(nbr, wgt, values, degrees, active,
                                  lanes=None, *, gather: str, reduce: str,
                                  mask_inactive: bool = True):
    """Plain version of the lane-axis kernel: the single-lane plain
    version applied to each listed lane, stacked to ``(k, R)``."""
    rows = range(values.shape[0]) if lanes is None \
        else lane_list(lanes, values.shape[0])
    outs = [edge_block_reduce_plain(nbr, wgt, values[i], degrees, active[i],
                                    gather=gather, reduce=reduce,
                                    mask_inactive=mask_inactive)
            for i in rows]
    R = nbr.shape[0]
    if not outs:
        return (values.new_empty((0, R)),
                torch.empty((0, R), dtype=torch.bool, device=values.device))
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def edge_block_reduce_lanes(
    nbr: torch.Tensor,        # (R, W) int32 neighbor ids, PAD-padded
    wgt: torch.Tensor,        # (R, W) float32 edge weights
    values: torch.Tensor,     # (k', V) int32 | float32 state, one row a lane
    degrees: torch.Tensor,    # (V,) int32 out-degrees
    active: torch.Tensor,     # (k', V) bool frontiers
    lanes=None,               # the rows to sweep, distinct; None: all
    *,
    gather: str,
    reduce: str,
    mask_inactive: bool = True,
    need_any: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Kernel 1 over k lanes: per lane and row, the reduce of the menu
    gather over the row's live slots.

    Returns ``(reduced (k, R) values.dtype, any_live (k, R) bool)``; row
    ``j`` of each is what :func:`edge_block_reduce` gives for lane
    ``lanes[j]`` alone, bit for bit (each lane reduces its slots in kernel
    1's order).  ``need_any=False`` skips the flags (returned as
    ``None``).  A lane map longer than
    :data:`~repro_torch.kernels.lanes.MAX_LANES` runs as several
    launches.
    """
    if gather not in GATHER_OPS or reduce not in REDUCE_OPS:
        raise ValueError(f"not a menu module: gather={gather!r}, "
                         f"reduce={reduce!r}")
    if gather == "div_deg" and not values.dtype.is_floating_point:
        raise ValueError("div_deg is a true division: it needs float values")
    if values.dim() != 2 or tuple(active.shape) != tuple(values.shape):
        raise ValueError(f"values and active: want (k, V) each, got "
                         f"{tuple(values.shape)} and {tuple(active.shape)}")
    if values.device.type == "cpu":
        red, any_live = edge_block_reduce_lanes_plain(
            nbr, wgt, values, degrees, active, lanes, gather=gather,
            reduce=reduce, mask_inactive=mask_inactive)
        return red, any_live if need_any else None
    if values.device.type != "cuda":
        raise ValueError(f"edge_block_reduce_lanes runs on CPU or CUDA "
                         f"tensors, got {values.device}")
    if values.dtype not in _VALUE_DTYPES:
        raise TypeError(f"the kernel takes int32 or float32 values, "
                        f"got {values.dtype}")
    R, W = nbr.shape
    kk, V = values.shape
    lanes = list(range(kk)) if lanes is None else lane_list(lanes, kk)
    k = len(lanes)
    want = {"nbr": (nbr, torch.int32, (R, W)),
            "wgt": (wgt, torch.float32, (R, W)),
            "values": (values, values.dtype, (kk, V)),
            "degrees": (degrees, torch.int32, (V,)),
            "active": (active, torch.bool, (kk, V))}
    for name, (t, dtype, shape) in want.items():
        if t.device != values.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want a contiguous {dtype} tensor of shape {shape} "
                f"on {values.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    out = torch.empty((k, R), dtype=values.dtype, device=values.device)
    any_live = torch.empty((k, R), dtype=torch.uint8, device=values.device) \
        if need_any else None
    if R == 0 or k == 0:
        return out, None if any_live is None else any_live.view(torch.bool)
    lib = _build.library("edge_block")
    stream = torch.cuda.current_stream(values.device).cuda_stream
    for lo, lane_map, kc, K in lane_chunks(lanes):
        bits = torch.empty((-(-V * K // 32),), dtype=torch.int32,
                           device=values.device) if mask_inactive else None
        msg = torch.empty((V * K,), dtype=values.dtype,
                          device=values.device)
        err = lib.edge_block_lanes_launch(
            values.device.index or 0, GATHER_OPS.index(gather),
            REDUCE_OPS.index(reduce), _VALUE_DTYPES[values.dtype],
            int(mask_inactive), K, nbr.data_ptr(), wgt.data_ptr(),
            values.data_ptr(), degrees.data_ptr(), active.data_ptr(),
            lane_map, kc, kk, None if bits is None else bits.data_ptr(),
            msg.data_ptr(), V, out[lo].data_ptr(),
            None if any_live is None else any_live[lo].data_ptr(), R, W,
            stream)
        if err != 0:
            raise RuntimeError(f"edge_block lane kernel launch failed: "
                               f"cudaError_t {err}")
        edge_block_reduce_lanes.lane_launches += 1
    return out, None if any_live is None else any_live.view(torch.bool)


# launches of the lane-axis kernel since the count was last set to 0
edge_block_reduce_lanes.lane_launches = 0


def _fold_check(gather, reduce, values, active):
    if gather not in GATHER_OPS or reduce not in REDUCE_OPS:
        raise ValueError(f"not a menu module: gather={gather!r}, "
                         f"reduce={reduce!r}")
    if gather == "div_deg" and not values.dtype.is_floating_point:
        raise ValueError("div_deg is a true division: it needs float values")
    if reduce == "add" and values.dtype.is_floating_point:
        raise ValueError("a float add's fold has an order: it takes "
                         "edge_block_reduce_lanes and subrow_combine")
    if values.dim() != 2 or tuple(active.shape) != tuple(values.shape):
        raise ValueError(f"values and active: want (k', V) each, got "
                         f"{tuple(values.shape)} and {tuple(active.shape)}")


def edge_block_fold_lanes_plain(plan, values, degrees, active, lanes, *,
                                gather: str, reduce: str,
                                mask_inactive: bool = True,
                                need_got: bool = True, red=None):
    """Plain version of the fused lane sweep: for each listed lane, the
    single-lane plain sweep over the flat view, then
    :func:`~repro_torch.kernels.pull_bitmap.subrow_combine` of its
    reductions and of its any-live flags, into that lane's row; a float
    min/max's tied zeros settled as the kernel's combines settle them
    (``ref.settle_zero_ties``)."""
    _fold_check(gather, reduce, values, active)
    kk, V = values.shape
    lanes = lane_list(lanes, kk)
    ident = _identity(reduce, values.dtype)
    if red is None:
        red = torch.full((kk, V), ident, dtype=values.dtype,
                         device=values.device)
    got = torch.zeros((kk, V), dtype=torch.bool, device=values.device) \
        if need_got else None

    def fold(sub_flags):
        return subrow_combine(sub_flags.to(torch.int8), plan, 0, "max",
                              torch.int8) != 0

    for i in lanes:
        msg, live = edge_block_messages(
            plan.flat_dst, plan.flat_wgt, values[i], degrees, active[i],
            gather=gather, reduce=reduce, mask_inactive=mask_inactive)
        red_i = subrow_combine(row_reduce(reduce, msg, 1), plan, ident,
                               reduce, values.dtype)
        if values.dtype.is_floating_point:      # min or max
            red_i = settle_zero_ties(
                red_i, fold(zero_wins(msg, reduce).any(1)), reduce)
        red[i] = red_i
        if need_got:
            got[i] = fold(live.any(1))
    return red, got


def edge_block_fold_lanes(
    plan,                     # PullBitmapPlan: flat_dst, flat_wgt, owner8
    values: torch.Tensor,     # (k', V) int32 | float32 state, one row a lane
    degrees: torch.Tensor,    # (V,) int32 out-degrees
    active: torch.Tensor,     # (k', V) bool frontiers
    lanes,                    # the rows to sweep, distinct, in [0, k')
    *,
    gather: str,
    reduce: str,
    mask_inactive: bool = True,
    need_got: bool = True,
    red: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The lane sweep with the sub-row fold fused in (min, max, int add).

    Returns ``(red (k', V), got (k', V) bool or None)``: row ``i`` of a
    listed lane holds, per vertex, the reduce of the menu gather over its
    live in-slots and whether it had one, bit for bit what
    :func:`edge_block_reduce` and ``subrow_combine`` give that lane alone
    (a float min/max tie of +0 and -0 settled in the order -0 < +0, as
    ``ref.settle_zero_ties`` says); rows not
    listed hold the identity and ``got`` 0.  ``red``, when given, is a
    ``(k', V)`` table holding the identity in the listed rows, which the
    call fills (other rows stay as they were): the lane push
    (``push_ell.push_ell_lanes_reduce``) shares it for the other lanes of
    a batched superstep.  A lane map longer than
    :data:`~repro_torch.kernels.lanes.MAX_LANES` runs
    as several launches.
    """
    _fold_check(gather, reduce, values, active)
    if values.device.type == "cpu":
        return edge_block_fold_lanes_plain(
            plan, values, degrees, active, lanes, gather=gather,
            reduce=reduce, mask_inactive=mask_inactive, need_got=need_got,
            red=red)
    if values.device.type != "cuda":
        raise ValueError(f"edge_block_fold_lanes runs on CPU or CUDA "
                         f"tensors, got {values.device}")
    if values.dtype not in _VALUE_DTYPES:
        raise TypeError(f"the kernel takes int32 or float32 values, "
                        f"got {values.dtype}")
    kk, V = values.shape
    lanes = lane_list(lanes, kk)
    nbr, wgt, owner8 = plan.flat_dst, plan.flat_wgt, plan.owner8
    R, W = nbr.shape
    want = {"flat_dst": (nbr, torch.int32, (R, W)),
            "flat_wgt": (wgt, torch.float32, (R, W)),
            "owner8": (owner8, torch.int32, (R,)),
            "values": (values, values.dtype, (kk, V)),
            "degrees": (degrees, torch.int32, (V,)),
            "active": (active, torch.bool, (kk, V))}
    if red is not None:
        want["red"] = (red, values.dtype, (kk, V))
    for name, (t, dtype, shape) in want.items():
        if t.device != values.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want a contiguous {dtype} tensor of shape {shape} "
                f"on {values.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    if red is None:
        red = torch.full((kk, V), _identity(reduce, values.dtype),
                         dtype=values.dtype, device=values.device)
    got = torch.zeros((kk, V), dtype=torch.uint8, device=values.device) \
        if need_got else None
    if not lanes or V == 0:
        return red, None if got is None else got.view(torch.bool)
    lib = _build.library("edge_block")
    stream = torch.cuda.current_stream(values.device).cuda_stream
    for _, lane_map, k, K in lane_chunks(lanes):
        bits = torch.empty((-(-V * K // 32),), dtype=torch.int32,
                           device=values.device) if mask_inactive else None
        msg = torch.empty((V * K,), dtype=values.dtype,
                          device=values.device)
        err = lib.edge_block_fold_launch(
            values.device.index or 0, GATHER_OPS.index(gather),
            REDUCE_OPS.index(reduce), _VALUE_DTYPES[values.dtype],
            int(mask_inactive), K, nbr.data_ptr(), wgt.data_ptr(),
            owner8.data_ptr(), values.data_ptr(), degrees.data_ptr(),
            active.data_ptr(), lane_map, k, kk,
            None if bits is None else bits.data_ptr(), msg.data_ptr(), V,
            red.data_ptr(), None if got is None else got.data_ptr(), R, W,
            stream)
        if err != 0:
            raise RuntimeError(f"edge_block fold kernel launch failed: "
                               f"cudaError_t {err}")
        edge_block_fold_lanes.launches += 1
    return red, None if got is None else got.view(torch.bool)


# launches of the fused lane sweep since the count was last set to 0
edge_block_fold_lanes.launches = 0
