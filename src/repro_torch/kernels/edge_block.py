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

The streamed engine (``core/stream.py``) sweeps one state over many
partitions.  Its pull partitions go through the fused lane sweep in
accumulate mode (``accumulate=True``): the ``(k', V)`` tables hold the
earlier partitions' partials, a whole run of owners combines into its
entry instead of overwriting it, and ``got`` is OR-ed.  A float add's
partitions go through :func:`edge_block_add_fold_lanes`
(``csrc/stream_fold.cu``): one launch and a carry fold gather a
partition's rows and fold them by owner in tiles of 256 threads x 8 rows
(kernel 4's tiles, kernel 1's row body) into the running table, in the
order of the route it replaced (kernel 1's row sums, kernel 4's fold,
then the add).  Every kernel's pre-pass runs apart from its main kernel:
:func:`lanes_prepare` (the lane kernels') and :func:`edge_block_prepare`
(kernel 1's) launch it, and the main kernel reads its tables.  A wrapper
given no tables (``prepared=None``) calls the prepare function itself;
the streamed engine calls it once a superstep and hands the tables to
each partition's launch.  The pre-pass launches count apart
(``launches`` of each prepare function).

The wrappers take the plain version for tensors on the CPU and launch the
kernel for tensors on a CUDA device; they never fall back from one to the
other.
"""
from __future__ import annotations

import torch

from . import _build
from .lanes import Prepared, check_prepared, lane_chunks, lane_list
from .pull_bitmap import subrow_combine
from .ref import (GATHER_OPS, REDUCE_OPS, _identity, combine_settled,
                  edge_block_messages, edge_block_reduce_ref, row_reduce,
                  segment_reduce_ref, settle_zero_ties, zero_wins)

_VALUE_DTYPES = {torch.float32: 1, torch.int32: 0}
_FLAG_DTYPES = (torch.bool, torch.int8, torch.uint8)
# gathers whose per-vertex message the kernel's pre-pass tabulates
_MESSAGE_TABLE = ("plus_one", "div_deg")
# the C entries' stage argument (csrc/lanes.cuh, Stage)
_PACK_ONLY, _MAIN_ONLY = 0, 1
# rows a tile of the streamed fold (csrc/stream_fold.cu's kTile): its carry
# scratch holds (2 k + 1) words a tile
FOLD_TILE = 256 * 8


def edge_block_reduce_plain(nbr, wgt, values, degrees, active, *, gather: str,
                            reduce: str, mask_inactive: bool = True,
                            block_live=None, block_rows: int | None = None,
                            prepared: Prepared | None = None):
    """Plain PyTorch version of the kernel (the oracle it is held to).

    With ``block_live``, the full sweep's rows of every dead block are
    overwritten with the identity and ``any=False``: what the early-out
    kernel computes, also where a caller marks a live block dead.
    ``prepared`` is only checked to be for this call: the answer comes
    from the state.
    """
    check_prepared(prepared, (0,), gather, mask_inactive)
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
    prepared: Prepared | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row reduce of the menu gather over live slots.

    Returns ``(reduced (R,) values.dtype, any_live (R,) bool)``.  Neighbor
    ids must be ``PAD`` or lie in ``[0, V)`` (the layout builders
    guarantee it; the kernel does not re-check per call).  ``block_live``
    (bool, int8 or uint8; nonzero is live) with ``block_rows`` selects the
    early-out variant: the rows of a dead block hold the identity and
    ``any=False``.  Callers pass a conservative liveness to get the full
    sweep's result.  ``prepared`` (:func:`edge_block_prepare`'s tables of
    this very state) spares the launch its own pre-pass.
    """
    check_prepared(prepared, (0,), gather, mask_inactive)
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
    if values.device.type in ("cpu", "meta"):
        # meta: the result's shape and dtype only; nothing runs
        return edge_block_reduce_plain(nbr, wgt, values, degrees, active,
                                       gather=gather, reduce=reduce,
                                       mask_inactive=mask_inactive,
                                       block_live=block_live,
                                       block_rows=block_rows,
                                       prepared=prepared)
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
    if prepared is None:
        prepared = edge_block_prepare(values, degrees, active, gather=gather,
                                      mask_inactive=mask_inactive)
    _, _, _, _, bits, msg = prepared.chunks[0]
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
        any_live.data_ptr(), R, W, _MAIN_ONLY, stream)
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


def edge_block_prepare(values, degrees, active, *, gather: str,
                       mask_inactive: bool = True) -> Prepared:
    """Kernel 1's pre-pass alone, for a ``(V,)`` state: its frontier
    bitmap (with ``mask_inactive``) and message table (``plus_one``,
    ``div_deg``), for the ``prepared=`` launches of
    :func:`edge_block_reduce` over any number of edge blocks of this very
    state.  CPU tensors get no tables (the plain version needs none);
    CUDA tensors launch the pre-pass (``edge_block_prepare.launches``)."""
    if gather not in GATHER_OPS:
        raise ValueError(f"not a menu gather: {gather!r}")
    V = values.shape[0]
    if values.device.type == "cpu":
        return Prepared((0,), gather, bool(mask_inactive), ())
    if values.device.type != "cuda" or values.dtype not in _VALUE_DTYPES:
        raise ValueError(f"edge_block_prepare takes int32/float32 tensors "
                         f"on CPU or CUDA, got {values.dtype} on "
                         f"{values.device}")
    bits = torch.empty((-(-V // 32),), dtype=torch.int32,
                       device=values.device) if mask_inactive else None
    msg = torch.empty_like(values) if gather in _MESSAGE_TABLE else None
    if V and (bits is not None or msg is not None):
        lib = _build.library("edge_block")
        err = lib.edge_block_reduce_launch(
            values.device.index or 0, GATHER_OPS.index(gather), 0,
            _VALUE_DTYPES[values.dtype], int(mask_inactive), None, 0, None,
            None, values.data_ptr(), degrees.data_ptr(), active.data_ptr(),
            None if bits is None else bits.data_ptr(),
            None if msg is None else msg.data_ptr(), V, None, None, 0, 8,
            _PACK_ONLY, torch.cuda.current_stream(values.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"edge_block pre-pass launch failed: "
                               f"cudaError_t {err}")
        edge_block_prepare.launches += 1
    return Prepared((0,), gather, bool(mask_inactive),
                    ((0, None, 1, 1, bits, msg),))


# launches of kernel 1's pre-pass alone since the count was last set to 0
edge_block_prepare.launches = 0


def lanes_prepare(values, degrees, active, lanes, *, gather: str,
                  mask_inactive: bool = True) -> Prepared:
    """The lane kernels' pre-pass alone (``lanes_pack_kernel``) for the
    rows ``lanes`` of a ``(k', V)`` state: per launch of at most 32 lanes,
    the K-bit frontier words (with ``mask_inactive``) and the vertex-major
    messages, for the ``prepared=`` launches of
    :func:`edge_block_fold_lanes` and :func:`edge_block_reduce_lanes` over
    any number of edge blocks of this very state.  CPU tensors get no
    tables (the plain versions need none); CUDA tensors launch the
    pre-pass (``lanes_prepare.launches``, one a launch)."""
    if gather not in GATHER_OPS:
        raise ValueError(f"not a menu gather: {gather!r}")
    kk, V = values.shape
    lanes = lane_list(lanes, kk)
    if values.device.type == "cpu":
        return Prepared(tuple(lanes), gather, bool(mask_inactive), ())
    if values.device.type != "cuda" or values.dtype not in _VALUE_DTYPES:
        raise ValueError(f"lanes_prepare takes int32/float32 tensors on "
                         f"CPU or CUDA, got {values.dtype} on "
                         f"{values.device}")
    chunks = []
    for lo, lane_map, k, K in lane_chunks(lanes):
        bits = torch.empty((-(-V * K // 32),), dtype=torch.int32,
                           device=values.device) if mask_inactive else None
        msg = torch.empty((V * K,), dtype=values.dtype, device=values.device)
        lib = _build.library("edge_block")
        err = lib.edge_block_lanes_launch(
            values.device.index or 0, GATHER_OPS.index(gather), 0,
            _VALUE_DTYPES[values.dtype], int(mask_inactive), K, None, None,
            values.data_ptr(), degrees.data_ptr(), active.data_ptr(),
            lane_map, k, kk, None if bits is None else bits.data_ptr(),
            msg.data_ptr(), V, None, None, 0, 8, _PACK_ONLY,
            torch.cuda.current_stream(values.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"edge_block lane pre-pass launch failed: "
                               f"cudaError_t {err}")
        lanes_prepare.launches += 1
        chunks.append((lo, lane_map, k, K, bits, msg))
    return Prepared(tuple(lanes), gather, bool(mask_inactive), tuple(chunks))


# launches of the lane kernels' pre-pass alone since the count was last
# set to 0
lanes_prepare.launches = 0


def edge_block_reduce_lanes_plain(nbr, wgt, values, degrees, active,
                                  lanes=None, *, gather: str, reduce: str,
                                  mask_inactive: bool = True,
                                  prepared: Prepared | None = None):
    """Plain version of the lane-axis kernel: the single-lane plain
    version applied to each listed lane, stacked to ``(k, R)``
    (``prepared`` only checked)."""
    rows = list(range(values.shape[0])) if lanes is None \
        else lane_list(lanes, values.shape[0])
    check_prepared(prepared, rows, gather, mask_inactive)
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
    prepared: Prepared | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Kernel 1 over k lanes: per lane and row, the reduce of the menu
    gather over the row's live slots.

    Returns ``(reduced (k, R) values.dtype, any_live (k, R) bool)``; row
    ``j`` of each is what :func:`edge_block_reduce` gives for lane
    ``lanes[j]`` alone, bit for bit (each lane reduces its slots in kernel
    1's order).  ``need_any=False`` skips the flags (returned as
    ``None``).  A lane map longer than
    :data:`~repro_torch.kernels.lanes.MAX_LANES` runs as several
    launches.  ``prepared`` (:func:`lanes_prepare`'s tables of this very
    state and lanes) spares the call its own pre-pass.
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
            reduce=reduce, mask_inactive=mask_inactive, prepared=prepared)
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
    check_prepared(prepared, lanes, gather, mask_inactive)
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
    if prepared is None:
        prepared = lanes_prepare(values, degrees, active, lanes,
                                 gather=gather, mask_inactive=mask_inactive)
    for lo, lane_map, kc, K, bits, msg in prepared.chunks:
        err = lib.edge_block_lanes_launch(
            values.device.index or 0, GATHER_OPS.index(gather),
            REDUCE_OPS.index(reduce), _VALUE_DTYPES[values.dtype],
            int(mask_inactive), K, nbr.data_ptr(), wgt.data_ptr(),
            values.data_ptr(), degrees.data_ptr(), active.data_ptr(),
            lane_map, kc, kk, None if bits is None else bits.data_ptr(),
            msg.data_ptr(), V, out[lo].data_ptr(),
            None if any_live is None else any_live[lo].data_ptr(), R, W,
            _MAIN_ONLY, stream)
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


def _fold_by_owner(rows: torch.Tensor, owner8: torch.Tensor, V: int,
                   reduce: str, ident) -> torch.Tensor:
    """Per-row values folded into their owners' ``(V,)`` entries (pad
    rows, owner ``V``, dropped): an order-free scatter, the plain form of
    the fold kernel's runs for any flat view."""
    idx = owner8.long()
    table = torch.full((V + 1,), ident, dtype=rows.dtype, device=rows.device)
    if reduce == "add":
        return table.index_add_(0, idx, rows)[:V]
    return table.scatter_reduce_(0, idx, rows, "amin" if reduce == "min"
                                 else "amax", include_self=True)[:V]


def edge_block_fold_lanes_plain(plan, values, degrees, active, lanes, *,
                                gather: str, reduce: str,
                                mask_inactive: bool = True,
                                need_got: bool = True, red=None, got=None,
                                accumulate: bool = False,
                                prepared: Prepared | None = None):
    """Plain version of the fused lane sweep: for each listed lane, the
    single-lane plain sweep over the flat view, then
    :func:`~repro_torch.kernels.pull_bitmap.subrow_combine` of its
    reductions and of its any-live flags, into that lane's row; a float
    min/max's tied zeros settled as the kernel's combines settle them
    (``ref.settle_zero_ties``).  In accumulate mode (any flat view: only
    ``flat_dst``, ``flat_wgt`` and ``owner8`` are read) each lane's rows
    fold into their owners by an order-free scatter and combine into the
    running ``red`` (``ref.combine_settled``), ``got`` OR-ed.
    ``prepared`` is only checked."""
    _fold_check(gather, reduce, values, active)
    kk, V = values.shape
    lanes = lane_list(lanes, kk)
    check_prepared(prepared, lanes, gather, mask_inactive)
    ident = _identity(reduce, values.dtype)
    if red is None:
        red = torch.full((kk, V), ident, dtype=values.dtype,
                         device=values.device)
    if not need_got:
        got = None
    elif got is None:
        got = torch.zeros((kk, V), dtype=torch.bool, device=values.device)

    def fold(rows, op, fill):
        if accumulate:
            return _fold_by_owner(rows, plan.owner8, V, op, fill)
        return subrow_combine(rows, plan, fill, op, rows.dtype)

    for i in lanes:
        msg, live = edge_block_messages(
            plan.flat_dst, plan.flat_wgt, values[i], degrees, active[i],
            gather=gather, reduce=reduce, mask_inactive=mask_inactive)
        red_i = fold(row_reduce(reduce, msg, 1), reduce, ident)
        if values.dtype.is_floating_point:      # min or max
            red_i = settle_zero_ties(red_i, fold(
                zero_wins(msg, reduce).any(1).to(torch.int8), "max", 0) != 0,
                reduce)
        got_i = fold(live.any(1).to(torch.int8), "max", 0) != 0 \
            if need_got else None
        if accumulate:
            red[i] = combine_settled(red[i], red_i, reduce)
            if need_got:
                got[i] |= got_i
        else:
            red[i] = red_i
            if need_got:
                got[i] = got_i
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
    got: torch.Tensor | None = None,
    accumulate: bool = False,
    prepared: Prepared | None = None,
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

    ``accumulate=True`` (the streamed engine's pull partitions; ``plan``
    may then be any flat view with ``flat_dst``, ``flat_wgt`` and
    ``owner8``): ``red`` (required) and ``got`` (a ``(k', V)`` bool table,
    required with ``need_got``) hold running partials, which the call
    combines the listed lanes' reductions into and ORs the flags into.
    ``got`` may be given without it too, holding 0 in the listed rows.
    ``prepared`` (:func:`lanes_prepare`'s tables of this very state and
    lanes) spares the call its own pre-pass.
    """
    _fold_check(gather, reduce, values, active)
    if accumulate and (red is None or (need_got and got is None)):
        raise ValueError("accumulate mode needs the running red table "
                         "(and got, with need_got)")
    if values.device.type == "cpu":
        return edge_block_fold_lanes_plain(
            plan, values, degrees, active, lanes, gather=gather,
            reduce=reduce, mask_inactive=mask_inactive, need_got=need_got,
            red=red, got=got, accumulate=accumulate, prepared=prepared)
    if values.device.type != "cuda":
        raise ValueError(f"edge_block_fold_lanes runs on CPU or CUDA "
                         f"tensors, got {values.device}")
    if values.dtype not in _VALUE_DTYPES:
        raise TypeError(f"the kernel takes int32 or float32 values, "
                        f"got {values.dtype}")
    kk, V = values.shape
    lanes = lane_list(lanes, kk)
    check_prepared(prepared, lanes, gather, mask_inactive)
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
    if need_got and got is not None:
        want["got"] = (got, torch.bool, (kk, V))
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
    if not need_got:
        got = None
    elif got is None:
        got = torch.zeros((kk, V), dtype=torch.bool, device=values.device)
    if not lanes or V == 0:
        return red, got
    lib = _build.library("edge_block")
    stream = torch.cuda.current_stream(values.device).cuda_stream
    if prepared is None:
        prepared = lanes_prepare(values, degrees, active, lanes,
                                 gather=gather, mask_inactive=mask_inactive)
    for _, lane_map, k, K, bits, msg in prepared.chunks:
        err = lib.edge_block_fold_launch(
            values.device.index or 0, GATHER_OPS.index(gather),
            REDUCE_OPS.index(reduce), _VALUE_DTYPES[values.dtype],
            int(mask_inactive), K, nbr.data_ptr(), wgt.data_ptr(),
            owner8.data_ptr(), values.data_ptr(), degrees.data_ptr(),
            active.data_ptr(), lane_map, k, kk,
            None if bits is None else bits.data_ptr(), msg.data_ptr(), V,
            red.data_ptr(), None if got is None else got.data_ptr(), R, W,
            int(accumulate), _MAIN_ONLY, stream)
        if err != 0:
            raise RuntimeError(f"edge_block fold kernel launch failed: "
                               f"cudaError_t {err}")
        edge_block_fold_lanes.launches += 1
        if accumulate:
            edge_block_fold_lanes.accumulate_launches += 1
    return red, got


# launches of the fused lane sweep since the counts were last set to 0, all
# of them and those in accumulate mode
edge_block_fold_lanes.launches = 0
edge_block_fold_lanes.accumulate_launches = 0


def edge_block_add_fold_lanes_plain(view, values, degrees, active, lanes, *,
                                    gather: str, mask_inactive: bool = True,
                                    red: torch.Tensor,
                                    got: torch.Tensor | None = None,
                                    prepared: Prepared | None = None):
    """Plain version of the streamed float-add fold, and the route the
    kernel replaced: for each listed lane, the row sums of
    :func:`edge_block_reduce_plain`, folded by owner
    (``ref.segment_reduce_ref``) into a ``(V,)`` partial added to
    ``red``'s row, and the rows' any-live flags folded by max and OR-ed
    into ``got``'s.  ``prepared`` is only checked."""
    kk, V = values.shape
    lanes = lane_list(lanes, kk)
    check_prepared(prepared, lanes, gather, mask_inactive)
    for i in lanes:
        sums, anys = edge_block_reduce_plain(
            view.flat_dst, view.flat_wgt, values[i], degrees, active[i],
            gather=gather, reduce="add", mask_inactive=mask_inactive)
        red[i] += segment_reduce_ref(view.owner8, sums, V, reduce="add")
        if got is not None:
            got[i] |= segment_reduce_ref(view.owner8, anys.to(torch.int32),
                                         V, reduce="max") > 0
    return red, got


def edge_block_add_fold_lanes(
    view,                     # flat_dst (R, W), flat_wgt (R, W), owner8 (R,)
    values: torch.Tensor,     # (k', V) float32 state, one row a lane
    degrees: torch.Tensor,    # (V,) int32 out-degrees
    active: torch.Tensor,     # (k', V) bool frontiers
    lanes,                    # the rows to sweep, distinct, in [0, k')
    *,
    gather: str,
    mask_inactive: bool = True,
    red: torch.Tensor,
    got: torch.Tensor | None = None,
    prepared: Prepared | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One streamed pull partition's float-add partial, added into the
    running tables (``csrc/stream_fold.cu``).

    ``view`` is a partition's rows: ``flat_dst`` PAD-padded source ids,
    ``flat_wgt`` their weights, ``owner8`` each row's owner vertex, equal
    owners in consecutive rows (owners outside ``[0, V)`` dropped).  For
    each listed lane ``i`` and each owner ``o`` with rows here,
    ``red[i, o] += `` the sum of the menu gather over those rows' live
    slots, and ``got[i, o]`` (a ``(k', V)`` bool table, or None) is set
    where one of them has a live slot.  The sum keeps the order of the
    route it replaced, bit for bit: each row in slot order from +0
    (kernel 1), the rows in tiles of 2,048 (kernel 4's association), then
    the add; entries of owners with no rows here are left as they are,
    which equals that route's ``+ 0`` wherever ``red`` holds no -0 (a
    running sum that starts at +0 never does).  The plain version sums in
    PyTorch's order: they agree within rtol 1e-5.  ``prepared``
    (:func:`lanes_prepare`'s tables of this very state and lanes) spares
    the call its own pre-pass.  Count: ``launches`` (one a launch of at
    most 32 lanes, its carry fold included).
    """
    if gather not in GATHER_OPS:
        raise ValueError(f"not a menu gather: {gather!r}")
    if not values.dtype.is_floating_point or values.dim() != 2 \
            or tuple(active.shape) != tuple(values.shape):
        raise ValueError(f"values and active: want a float (k', V) state "
                         f"each, got {values.dtype} {tuple(values.shape)} "
                         f"and {tuple(active.shape)}")
    if values.device.type == "cpu":
        return edge_block_add_fold_lanes_plain(
            view, values, degrees, active, lanes, gather=gather,
            mask_inactive=mask_inactive, red=red, got=got,
            prepared=prepared)
    if values.device.type != "cuda":
        raise ValueError(f"edge_block_add_fold_lanes runs on CPU or CUDA "
                         f"tensors, got {values.device}")
    if values.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 values, got "
                        f"{values.dtype}")
    kk, V = values.shape
    lanes = lane_list(lanes, kk)
    check_prepared(prepared, lanes, gather, mask_inactive)
    nbr, wgt, owner8 = view.flat_dst, view.flat_wgt, view.owner8
    R, W = nbr.shape
    want = {"flat_dst": (nbr, torch.int32, (R, W)),
            "flat_wgt": (wgt, torch.float32, (R, W)),
            "owner8": (owner8, torch.int32, (R,)),
            "degrees": (degrees, torch.int32, (V,)),
            "active": (active, torch.bool, (kk, V)),
            "red": (red, values.dtype, (kk, V))}
    if got is not None:
        want["got"] = (got, torch.bool, (kk, V))
    for name, (t, dtype, shape) in want.items():
        if t.device != values.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want a contiguous {dtype} tensor of shape {shape} "
                f"on {values.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    if not lanes or R == 0 or V == 0:
        return red, got
    if prepared is None:
        prepared = lanes_prepare(values, degrees, active, lanes,
                                 gather=gather, mask_inactive=mask_inactive)
    # per tile and lane the first and last run's partials, per tile flags:
    # one scratch for all launches, which run in stream order
    tiles = -(-R // FOLD_TILE)
    widest = max(c[2] for c in prepared.chunks)
    carries = torch.empty(((2 * widest + 1) * tiles,), dtype=torch.int32,
                          device=values.device)
    lib = _build.library("stream_fold")
    stream = torch.cuda.current_stream(values.device).cuda_stream
    for _, lane_map, k, K, bits, msg in prepared.chunks:
        err = lib.stream_fold_launch(
            values.device.index or 0, GATHER_OPS.index(gather),
            int(mask_inactive), K, nbr.data_ptr(), wgt.data_ptr(),
            owner8.data_ptr(), lane_map, k, kk,
            None if bits is None else bits.data_ptr(), msg.data_ptr(), V,
            red.data_ptr(), None if got is None else got.data_ptr(),
            carries.data_ptr(), tiles, R, W, stream)
        if err != 0:
            raise RuntimeError(f"stream_fold kernel launch failed: "
                               f"cudaError_t {err}")
        edge_block_add_fold_lanes.launches += 1
    return red, got


# launches of the streamed float-add fold since the count was last set to 0
edge_block_add_fold_lanes.launches = 0
