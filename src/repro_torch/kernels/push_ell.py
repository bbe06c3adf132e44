"""Frontier-compacted forward-ELL push module.

Counterpart of ``repro.kernels.push_ell``, in two stages:

1. **Compaction** — the live forward-ELL rows (a vertex with out-degree
   ``d`` owns ``ceil(d/width)`` rows) compact into a fixed-capacity buffer
   of row ids, in storage order (:func:`compact_rows`).
2. **Messages and combine** — each compacted row's source state is
   gathered once, each non-PAD slot's message computed, and the messages
   combined into a ``(V,)`` identity-filled table, which matches
   ``jax.ops.segment_min/max/sum``'s empty-segment fill.  On a CUDA
   device this is one hand-written kernel, ``csrc/push_ell.cu``'s fused
   kernel (:func:`push_ell_fused_reduce`): it reads the rows in place
   through the compaction and combines with atomics, so no ``(C, W)``
   block or message is written.  On the CPU, and for a gather outside
   the menu, it is the plain version (:func:`push_ell_fused_reduce_plain`):
   the ``(C, W)`` blocks gathered, the messages computed, and
   ``scatter_reduce_`` into a ``(V+1,)`` table whose dummy slot ``V`` takes
   the PAD slots.  Push is legal only for min, max and integer add, so
   the combine is exact in any order.

:func:`push_ell_message_block` (``csrc/push_ell.cu``'s message kernel) is
the counterpart of the JAX function of that name, the message stage
alone; the translator's push path no longer calls it.

:func:`push_ell_lanes_reduce` is the push over k lanes of a ``(k', V)``
state at once (``csrc/push_ell.cu``'s lane kernel), the counterpart of
the same call under ``jax.vmap`` in the JAX package's batched runs.  It
needs no compaction: the combine is exact in any order, so a scan reads
8 forward-ELL rows a thread and their sources' lane bits (packed by a
pre-pass), queues the rows live in some lane, and a warp's threads push
the queued rows one a thread, setting ``got`` by an OR.  The lanes are
rows of the state named by a lane map passed by value; each lane's table
row equals its compacted push's bit for bit.  The streamed engine
(``core/stream.py``) runs it over each push partition's forward ELL into
one running ``(k', V)`` table (its atomics combine into the earlier
partitions' partials) with ``got=`` (where a live message landed), after
one pre-pass a superstep (:func:`push_lanes_prepare`, ``prepared=``).

:func:`push_lanes_touched` is the lane push's scan with a one-byte
message (the kernel given no table): for each listed lane, which
vertices have an active in-neighbour, the touched table the bitmap
plane's batched superstep builds its block flags from (the JAX package's
``touched_frontier``, there XLA and one lane at a time under ``vmap``).

Work is O(R + capacity·width) per superstep; the translator picks the
capacity tier from the live row count ``r_f`` (or the dense fallback).
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from . import _build
from .lanes import Prepared, check_prepared, lane_chunks, lane_list
from .ref import (_SCATTER_REDUCE, GATHER_OPS, PAD, REDUCE_OPS,
                  combine_settled, gather_msg, settle_zero_ties, zero_wins)

_VALUE_DTYPES = {torch.float32: 1, torch.int32: 0}
# the C entry's stage argument (csrc/lanes.cuh, Stage)
_PACK_ONLY, _MAIN_ONLY = 0, 1


def compact_rows(live: torch.Tensor, num_rows: int, capacity: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact a boolean row mask into ``capacity`` live row indices.

    Returns ``(sel (capacity,) int32, ok (capacity,) bool)``: ``sel[i]``
    is the i-th live row in storage order, and ``sel`` is 0 where ``ok``
    is False (past the live count, or past ``num_rows``).  The same
    selection as the JAX package's bitmap form
    (``repro_torch.core.graph.bitmap_select`` over packed words), here as
    an inclusive cumsum and a ``searchsorted`` — both sync-free on a GPU.
    Rows beyond ``capacity`` are dropped: callers guarantee
    ``capacity >= live.sum()`` (the translator's tier guard does).
    """
    cum = torch.cumsum(live, dim=0)                      # int64, inclusive
    slots = torch.arange(1, capacity + 1, dtype=cum.dtype,
                         device=live.device)
    idx = torch.searchsorted(cum, slots)
    ok = idx < min(num_rows, live.shape[0])
    return torch.where(ok, idx, 0).to(torch.int32), ok


def push_ell_message_block_plain(dst_blk, wgt_blk, src_blk, values, degrees,
                                 *, gather: str | None = None,
                                 gather_fn: Callable | None = None):
    """Plain message stage: gather each row's source state once, broadcast
    it over the row's slots, apply the gather (menu name or callable)."""
    if gather_fn is None:
        gather_fn = partial(gather_msg, gather)
    src = src_blk.long()
    v = values[src]
    d = degrees[src]
    shape = dst_blk.shape
    return gather_fn(v[:, None].expand(shape),
                     wgt_blk.expand(shape).to(v.dtype),
                     d[:, None].expand(shape))


def push_ell_message_block(dst_blk, wgt_blk, src_blk, values, degrees, *,
                           gather: str) -> torch.Tensor:
    """Messages of a compacted ``(C, W)`` block, ``(C, W)`` values.dtype.

    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/push_ell.cu``.  PAD masking stays with the caller (the combine
    stage), as in the TPU kernel; ``dst_blk`` only fixes the shape.
    """
    if gather not in GATHER_OPS:
        raise ValueError(f"not a menu gather: {gather!r}")
    if gather == "div_deg" and not values.dtype.is_floating_point:
        raise ValueError("div_deg is a true division: it needs float values")
    if values.device.type in ("cpu", "meta"):
        # meta: the result's shape and dtype only; nothing runs
        return push_ell_message_block_plain(dst_blk, wgt_blk, src_blk, values,
                                            degrees, gather=gather)
    if values.device.type != "cuda":
        raise ValueError(f"push_ell_message_block runs on CPU or CUDA "
                         f"tensors, got {values.device}")
    if values.dtype not in _VALUE_DTYPES:
        raise TypeError(f"the kernel takes int32 or float32 values, "
                        f"got {values.dtype}")
    C, W = dst_blk.shape
    V = values.shape[0]
    want = {"dst_blk": (dst_blk, torch.int32, (C, W)),
            "wgt_blk": (wgt_blk, torch.float32, (C, W)),
            "src_blk": (src_blk, torch.int32, (C,)),
            "values": (values, values.dtype, (V,)),
            "degrees": (degrees, torch.int32, (V,))}
    for name, (t, dtype, shape) in want.items():
        if t.device != values.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want a contiguous {dtype} tensor of shape {shape} "
                f"on {values.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    out = torch.empty((C, W), dtype=values.dtype, device=values.device)
    if C * W == 0:
        return out
    lib = _build.library("push_ell")
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = lib.push_ell_message_launch(
        values.device.index or 0, GATHER_OPS.index(gather),
        _VALUE_DTYPES[values.dtype], wgt_blk.data_ptr(), src_blk.data_ptr(),
        values.data_ptr(), degrees.data_ptr(), out.data_ptr(), C, W, stream)
    if err != 0:
        raise RuntimeError(f"push_ell message kernel launch failed: "
                           f"cudaError_t {err}")
    push_ell_message_block.launches += 1
    return out


# launches of the CUDA kernel since the count was last set to 0
push_ell_message_block.launches = 0


def push_ell_reduce(row_src, ell_dst, ell_wgt, values, degrees, active, *,
                    num_rows: int, capacity: int, gather_fn: Callable,
                    reduce: str, identity, num_vertices: int,
                    dtype: torch.dtype, gather_module: str | None = None,
                    use_kernels: bool = False, emit_touched: bool = False):
    """Frontier-compacted push superstep reduce: ``(red, touched)``.

    ``red[v]`` is the combine of every live message targeting ``v``
    (``identity`` where none).  Correct only while ``capacity`` covers the
    live row count.
    """
    live = active[row_src.long()]
    if num_rows == 0:
        live = torch.zeros_like(live)
    return compacted_push_reduce(
        row_src, ell_dst, ell_wgt, live, values, degrees,
        num_rows=num_rows, capacity=capacity, gather_fn=gather_fn,
        reduce=reduce, identity=identity, num_vertices=num_vertices,
        dtype=dtype, gather_module=gather_module, use_kernels=use_kernels,
        emit_touched=emit_touched)


def push_ell_fused_reduce_plain(sel, ok, row_src, ell_dst, ell_wgt, values,
                                degrees, *, reduce: str, identity,
                                num_vertices: int, dtype: torch.dtype,
                                gather: str | None = None,
                                gather_fn: Callable | None = None,
                                emit_touched: bool = False):
    """Plain messages-and-combine over compacted rows: ``(red, touched)``.

    The ``(C, W)`` blocks of the rows ``sel`` (PAD where not ``ok``) are
    gathered, their messages computed (menu name or callable), and the
    valid slots' messages scattered into a ``(V+1,)`` identity-filled
    table, PAD slots into the dummy slot ``V``, which is sliced off (a
    float min/max's tied zeros settled as the kernels' atomics settle
    them, ``ref.settle_zero_ties``); with
    ``emit_touched``, a ``(V,)`` bool mask of the destinations of valid
    slots.
    """
    sel = sel.long()
    dst_blk = torch.where(ok[:, None], ell_dst[sel], PAD)   # (cap, W)
    msg = push_ell_message_block_plain(dst_blk, ell_wgt[sel], row_src[sel],
                                       values, degrees, gather=gather,
                                       gather_fn=gather_fn)
    if isinstance(identity, torch.Tensor):
        identity = identity.item()
    valid = dst_blk != PAD
    segs = torch.where(valid, dst_blk, num_vertices).reshape(-1).long()
    flat = torch.where(valid, msg.to(dtype), identity).reshape(-1)
    table = torch.full((num_vertices + 1,), identity, dtype=dtype,
                       device=values.device)
    red = table.scatter_reduce_(0, segs, flat, _SCATTER_REDUCE[reduce],
                                include_self=True)[:num_vertices]
    if reduce != "add" and dtype.is_floating_point:
        wins = torch.zeros((num_vertices + 1,), dtype=torch.uint8,
                           device=values.device).scatter_reduce_(
            0, segs, zero_wins(flat, reduce).to(torch.uint8), "amax",
            include_self=True)[:num_vertices] != 0
        red = settle_zero_ties(red, wins, reduce)
    touched = None
    if emit_touched:
        touched = torch.zeros((num_vertices + 1,), dtype=torch.uint8,
                              device=values.device).scatter_reduce_(
            0, segs, valid.reshape(-1).to(torch.uint8), "amax",
            include_self=True)[:num_vertices] != 0
    return red, touched


def push_ell_fused_reduce(sel, ok, row_src, ell_dst, ell_wgt, values,
                          degrees, *, gather: str, reduce: str, identity,
                          num_vertices: int, dtype: torch.dtype,
                          emit_touched: bool = False):
    """Messages of the compacted rows combined into a ``(V,)`` table:
    ``(red, touched)``, ``touched`` a ``(V,)`` bool mask or ``None``.

    ``sel``/``ok`` are :func:`compact_rows`' output; the forward ELL
    (``row_src``, ``ell_dst``, ``ell_wgt``) is read in place.  CPU tensors
    take :func:`push_ell_fused_reduce_plain`; CUDA tensors launch
    ``csrc/push_ell.cu``'s fused kernel, which combines with atomics and so
    takes min, max and integer add only (the reduces a push may run).
    """
    if gather not in GATHER_OPS:
        raise ValueError(f"not a menu gather: {gather!r}")
    if reduce not in REDUCE_OPS:
        raise ValueError(f"not a menu reduce: {reduce!r}")
    if gather == "div_deg" and not values.dtype.is_floating_point:
        raise ValueError("div_deg is a true division: it needs float values")
    if values.device.type == "cpu":
        return push_ell_fused_reduce_plain(
            sel, ok, row_src, ell_dst, ell_wgt, values, degrees,
            reduce=reduce, identity=identity, num_vertices=num_vertices,
            dtype=dtype, gather=gather, emit_touched=emit_touched)
    if values.device.type != "cuda":
        raise ValueError(f"push_ell_fused_reduce runs on CPU or CUDA "
                         f"tensors, got {values.device}")
    if values.dtype not in _VALUE_DTYPES or dtype != values.dtype:
        raise TypeError(f"the kernel takes int32 or float32 values of the "
                        f"table's dtype, got {values.dtype} for {dtype}")
    if reduce == "add" and dtype.is_floating_point:
        raise ValueError("a float add is not a push reduce: its sum "
                         "depends on the order of the atomics")
    C = sel.shape[0]
    R, W = ell_dst.shape
    V = values.shape[0]
    if num_vertices != V:
        raise ValueError(f"num_vertices {num_vertices} != values' {V}")
    want = {"sel": (sel, torch.int32, (C,)),
            "ok": (ok, torch.bool, (C,)),
            "row_src": (row_src, torch.int32, (R,)),
            "ell_dst": (ell_dst, torch.int32, (R, W)),
            "ell_wgt": (ell_wgt, torch.float32, (R, W)),
            "values": (values, values.dtype, (V,)),
            "degrees": (degrees, torch.int32, (V,))}
    for name, (t, t_dtype, shape) in want.items():
        if t.device != values.device or t.dtype != t_dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want a contiguous {t_dtype} tensor of shape "
                f"{shape} on {values.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    if isinstance(identity, torch.Tensor):
        identity = identity.item()
    table = torch.full((V,), identity, dtype=dtype, device=values.device)
    touched = (torch.zeros((V,), dtype=torch.bool, device=values.device)
               if emit_touched else None)
    if C == 0 or V == 0:
        return table, touched
    lib = _build.library("push_ell")
    stream = torch.cuda.current_stream(values.device).cuda_stream
    err = lib.push_ell_fused_launch(
        values.device.index or 0, GATHER_OPS.index(gather),
        REDUCE_OPS.index(reduce), _VALUE_DTYPES[values.dtype],
        sel.data_ptr(), ok.data_ptr(), row_src.data_ptr(),
        ell_dst.data_ptr(), ell_wgt.data_ptr(), values.data_ptr(),
        degrees.data_ptr(), table.data_ptr(),
        touched.data_ptr() if touched is not None else None, C, W, V,
        stream)
    if err != 0:
        raise RuntimeError(f"push_ell fused kernel launch failed: "
                           f"cudaError_t {err}")
    push_ell_fused_reduce.launches += 1
    return table, touched


# launches of the CUDA kernel since the count was last set to 0
push_ell_fused_reduce.launches = 0


def compacted_push_reduce(row_src, ell_dst, ell_wgt, live, values, degrees,
                          *, num_rows: int, capacity: int,
                          gather_fn: Callable, reduce: str, identity,
                          num_vertices: int, dtype: torch.dtype,
                          gather_module: str | None = None,
                          use_kernels: bool = False,
                          emit_touched: bool = False):
    """Compaction, then messages and combine, over a live-row mask.

    With ``use_kernels`` the messages and combine are the fused CUDA
    kernel (:func:`push_ell_fused_reduce`), which evaluates menu gathers
    only; otherwise the plain version runs the program's own
    ``gather_fn``, as the JAX package's XLA path does.
    """
    if reduce not in REDUCE_OPS:
        raise ValueError(reduce)
    if use_kernels and gather_module is None:
        raise ValueError("the push kernel needs a menu gather")
    sel, ok = compact_rows(live, num_rows, capacity)
    if use_kernels:
        return push_ell_fused_reduce(
            sel, ok, row_src, ell_dst, ell_wgt, values, degrees,
            gather=gather_module, reduce=reduce, identity=identity,
            num_vertices=num_vertices, dtype=dtype,
            emit_touched=emit_touched)
    return push_ell_fused_reduce_plain(
        sel, ok, row_src, ell_dst, ell_wgt, values, degrees, reduce=reduce,
        identity=identity, num_vertices=num_vertices, dtype=dtype,
        gather_fn=gather_fn, emit_touched=emit_touched)


def push_ell_lanes_reduce_plain(row_src, ell_dst, ell_wgt, values, degrees,
                                active, lanes, *, num_rows: int, gather: str,
                                reduce: str, identity, table=None, got=None,
                                prepared: Prepared | None = None):
    """Plain version of the lane push: for each listed lane, its compacted
    push (:func:`compact_rows` over the lane's live rows, then
    :func:`push_ell_fused_reduce_plain`) combined into that lane's row
    (``ref.combine_settled``, as the atomics combine), and with ``got``,
    the touched destinations OR-ed into that lane's row.  ``prepared`` is
    only checked."""
    kk, V = values.shape
    lanes = lane_list(lanes, kk)
    check_prepared(prepared, lanes, "copy", True)
    if table is None:
        table = torch.full((kk, V), identity, dtype=values.dtype,
                           device=values.device)
    src = row_src.long()
    for i in lanes:
        live = active[i][src]
        if num_rows == 0:
            live = torch.zeros_like(live)
        sel, ok = compact_rows(live, num_rows, live.shape[0])
        red, touched = push_ell_fused_reduce_plain(
            sel, ok, row_src, ell_dst, ell_wgt, values[i], degrees,
            reduce=reduce, identity=identity, num_vertices=V,
            dtype=values.dtype, gather=gather, emit_touched=got is not None)
        table[i] = combine_settled(table[i], red, reduce)
        if got is not None:
            got[i] |= touched
    return table


def push_lanes_prepare(active, lanes) -> Prepared:
    """The lane push's pre-pass alone (``lanes_pack_kernel`` without
    messages) for the rows ``lanes`` of a ``(k', V)`` frontier: per launch
    of at most 32 lanes, the K-bit frontier words, for the ``prepared=``
    launches of :func:`push_ell_lanes_reduce` over any number of forward
    ELLs of this very state.  CPU tensors get no tables (the plain
    version needs none); CUDA tensors launch the pre-pass
    (``push_lanes_prepare.launches``, one a launch)."""
    kk, V = active.shape
    lanes = lane_list(lanes, kk)
    if active.device.type == "cpu":
        return Prepared(tuple(lanes), "copy", True, ())
    chunks = []
    for lo, lane_map, k, K in lane_chunks(lanes):
        bits = torch.empty((-(-V * K // 32),), dtype=torch.int32,
                           device=active.device)
        lib = _build.library("push_ell")
        err = lib.push_ell_lanes_launch(
            active.device.index or 0, GATHER_OPS.index("copy"),
            REDUCE_OPS.index("min"), 0, K, None, None, None, None, None,
            active.data_ptr(), lane_map, k, kk, bits.data_ptr(), None, None,
            0, 8, V, _PACK_ONLY,
            torch.cuda.current_stream(active.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"push_ell lane pre-pass launch failed: "
                               f"cudaError_t {err}")
        push_lanes_prepare.launches += 1
        chunks.append((lo, lane_map, k, K, bits, None))
    return Prepared(tuple(lanes), "copy", True, tuple(chunks))


# launches of the lane push's pre-pass alone since the count was last set
# to 0
push_lanes_prepare.launches = 0


def push_ell_lanes_reduce(
    row_src: torch.Tensor,    # (R,) int32 source vertex a forward-ELL row
    ell_dst: torch.Tensor,    # (R, W) int32 destinations, PAD-padded
    ell_wgt: torch.Tensor,    # (R, W) float32 edge weights
    values: torch.Tensor,     # (k', V) int32 | float32 state, one row a lane
    degrees: torch.Tensor,    # (V,) int32 out-degrees
    active: torch.Tensor,     # (k', V) bool frontiers
    lanes,                    # the rows that push, distinct, in [0, k')
    *,
    num_rows: int,
    gather: str,
    reduce: str,
    identity,
    table: torch.Tensor | None = None,
    got: torch.Tensor | None = None,
    prepared: Prepared | None = None,
) -> torch.Tensor:
    """The push superstep's reduce over the listed lanes: ``(k', V)``.

    Row ``i`` of a listed lane holds, per vertex, the combine of the
    messages its live rows (the first ``num_rows`` rows of the forward
    ELL whose source is active in the lane) send there, ``identity``
    where none; bit for bit :func:`push_ell_reduce` on that lane alone.
    ``table``, when given, is a ``(k', V)`` table holding ``identity`` in
    the listed rows, which the call fills (other rows stay as they were);
    else a fresh one holds ``identity`` in every row not listed.  The
    combine is exact in any order, so ``table`` may hold running partials
    (the streamed engine's earlier partitions), which the messages combine
    into.  ``got``, a ``(k', V)`` bool table, takes True where a listed
    lane's live message landed (OR-ed in).  ``prepared``
    (:func:`push_lanes_prepare`'s words of this very frontier and lanes)
    spares the call its own pre-pass.  Min, max and integer add only (the
    reduces a push may run).
    """
    if gather not in GATHER_OPS or reduce not in REDUCE_OPS:
        raise ValueError(f"not a menu module: gather={gather!r}, "
                         f"reduce={reduce!r}")
    if gather == "div_deg" and not values.dtype.is_floating_point:
        raise ValueError("div_deg is a true division: it needs float values")
    if reduce == "add" and values.dtype.is_floating_point:
        raise ValueError("a float add is not a push reduce: its sum "
                         "depends on the order of the atomics")
    if values.dim() != 2 or tuple(active.shape) != tuple(values.shape):
        raise ValueError(f"values and active: want (k', V) each, got "
                         f"{tuple(values.shape)} and {tuple(active.shape)}")
    if isinstance(identity, torch.Tensor):
        identity = identity.item()
    if values.device.type == "cpu":
        return push_ell_lanes_reduce_plain(
            row_src, ell_dst, ell_wgt, values, degrees, active, lanes,
            num_rows=num_rows, gather=gather, reduce=reduce,
            identity=identity, table=table, got=got, prepared=prepared)
    if values.device.type != "cuda":
        raise ValueError(f"push_ell_lanes_reduce runs on CPU or CUDA "
                         f"tensors, got {values.device}")
    if values.dtype not in _VALUE_DTYPES:
        raise TypeError(f"the kernel takes int32 or float32 values, "
                        f"got {values.dtype}")
    kk, V = values.shape
    lanes = lane_list(lanes, kk)
    check_prepared(prepared, lanes, "copy", True)
    R, W = ell_dst.shape
    if not 0 <= num_rows <= R:
        raise ValueError(f"num_rows {num_rows} outside [0, {R}]")
    want = {"row_src": (row_src, torch.int32, (R,)),
            "ell_dst": (ell_dst, torch.int32, (R, W)),
            "ell_wgt": (ell_wgt, torch.float32, (R, W)),
            "values": (values, values.dtype, (kk, V)),
            "degrees": (degrees, torch.int32, (V,)),
            "active": (active, torch.bool, (kk, V))}
    if table is not None:
        want["table"] = (table, values.dtype, (kk, V))
    if got is not None:
        want["got"] = (got, torch.bool, (kk, V))
    for name, (t, dtype, shape) in want.items():
        if t.device != values.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want a contiguous {dtype} tensor of shape {shape} "
                f"on {values.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    if table is None:
        table = torch.full((kk, V), identity, dtype=values.dtype,
                           device=values.device)
    if not lanes or V == 0:
        return table
    lib = _build.library("push_ell")
    stream = torch.cuda.current_stream(values.device).cuda_stream
    if prepared is None:
        prepared = push_lanes_prepare(active, lanes)
    for _, lane_map, k, K, bits, _ in prepared.chunks:
        err = lib.push_ell_lanes_launch(
            values.device.index or 0, GATHER_OPS.index(gather),
            REDUCE_OPS.index(reduce), _VALUE_DTYPES[values.dtype], K,
            row_src.data_ptr(), ell_dst.data_ptr(), ell_wgt.data_ptr(),
            values.data_ptr(), degrees.data_ptr(), active.data_ptr(),
            lane_map, k, kk, bits.data_ptr(), table.data_ptr(),
            None if got is None else got.data_ptr(), num_rows, W, V,
            _MAIN_ONLY, stream)
        if err != 0:
            raise RuntimeError(f"push_ell lane kernel launch failed: "
                               f"cudaError_t {err}")
        push_ell_lanes_reduce.launches += 1
    return table


# launches of the lane push kernel since the count was last set to 0
push_ell_lanes_reduce.launches = 0


def push_lanes_touched_plain(row_src, ell_dst, active, lanes, *,
                             num_rows: int, got=None,
                             prepared: Prepared | None = None):
    """Plain version of :func:`push_lanes_touched`: for each listed lane,
    the destinations of its live rows set in its row of ``got``.
    ``prepared`` is only checked."""
    kk, V = active.shape
    lanes = lane_list(lanes, kk)
    check_prepared(prepared, lanes, "copy", True)
    if got is None:
        got = torch.zeros((kk, V), dtype=torch.bool, device=active.device)
    src = row_src[:num_rows].long()
    dst = ell_dst[:num_rows]
    for i in lanes:
        d = dst[active[i][src]]
        got[i, d[d != PAD].long()] = True
    return got


def push_lanes_touched(
    row_src: torch.Tensor,    # (R,) int32 source vertex a forward-ELL row
    ell_dst: torch.Tensor,    # (R, W) int32 destinations, PAD-padded
    active: torch.Tensor,     # (k', V) bool frontiers
    lanes,                    # the rows to scan, distinct, in [0, k')
    *,
    num_rows: int,
    got: torch.Tensor | None = None,
    prepared: Prepared | None = None,
) -> torch.Tensor:
    """The touched tables of the listed lanes: ``(k', V)`` bool.

    Row ``i`` of a listed lane is True where a vertex has an active
    in-neighbour in that lane (the destination of a valid slot of one of
    the first ``num_rows`` forward-ELL rows whose source is active): bit
    for bit ``pull_bitmap.touched_table`` of that lane alone, at any
    capacity that covers its live rows.  ``got``, when given, is a
    ``(k', V)`` bool table holding False in the listed rows, which the
    call fills; else a fresh one holds False in every row not listed.  On
    CUDA it is the lane push's kernel given no table (one launch of at
    most 32 lanes, count ``launches``), after its pre-pass
    (:func:`push_lanes_prepare`, or ``prepared=``).
    """
    if active.dim() != 2 or active.dtype != torch.bool:
        raise ValueError(f"active: want a (k', V) bool frontier, got "
                         f"{active.dtype} {tuple(active.shape)}")
    if active.device.type == "cpu":
        return push_lanes_touched_plain(row_src, ell_dst, active, lanes,
                                        num_rows=num_rows, got=got,
                                        prepared=prepared)
    if active.device.type != "cuda":
        raise ValueError(f"push_lanes_touched runs on CPU or CUDA tensors, "
                         f"got {active.device}")
    kk, V = active.shape
    lanes = lane_list(lanes, kk)
    check_prepared(prepared, lanes, "copy", True)
    R, W = ell_dst.shape
    if not 0 <= num_rows <= R:
        raise ValueError(f"num_rows {num_rows} outside [0, {R}]")
    want = {"row_src": (row_src, torch.int32, (R,)),
            "ell_dst": (ell_dst, torch.int32, (R, W))}
    if got is not None:
        want["got"] = (got, torch.bool, (kk, V))
    for name, (t, dtype, shape) in want.items():
        if t.device != active.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want a contiguous {dtype} tensor of shape {shape} "
                f"on {active.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    if got is None:
        got = torch.zeros((kk, V), dtype=torch.bool, device=active.device)
    if not lanes or V == 0:
        return got
    lib = _build.library("push_ell")
    stream = torch.cuda.current_stream(active.device).cuda_stream
    if prepared is None:
        prepared = push_lanes_prepare(active, lanes)
    for _, lane_map, k, K, bits, _ in prepared.chunks:
        err = lib.push_ell_lanes_launch(
            active.device.index or 0, GATHER_OPS.index("copy"),
            REDUCE_OPS.index("max"), 0, K, row_src.data_ptr(),
            ell_dst.data_ptr(), None, None, None, active.data_ptr(),
            lane_map, k, kk, bits.data_ptr(), None, got.data_ptr(),
            num_rows, W, V, _MAIN_ONLY, stream)
        if err != 0:
            raise RuntimeError(f"push_ell touched launch failed: "
                               f"cudaError_t {err}")
        push_lanes_touched.launches += 1
    return got


# launches of the lane push's touched-only kernel since the count was last
# set to 0
push_lanes_touched.launches = 0
