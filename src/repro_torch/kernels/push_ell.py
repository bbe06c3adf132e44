"""Frontier-compacted forward-ELL push module.

Counterpart of ``repro.kernels.push_ell``, in three stages:

1. **Compaction** — the live forward-ELL rows (a vertex with out-degree
   ``d`` owns ``ceil(d/width)`` rows) compact into a fixed-capacity buffer
   of row ids, in storage order (:func:`compact_rows`).
2. **Messages** — the compacted rows' ``(capacity, width)`` blocks are
   gathered and each slot's message computed: on a CUDA device by the
   hand-written kernel ``csrc/push_ell.cu`` (:func:`push_ell_message_block`),
   on the CPU by its plain version.
3. **Combine** — messages land in a ``(V+1,)`` identity-filled table with
   ``scatter_reduce_`` (PAD slots go to the dummy slot ``V``, sliced off),
   which matches ``jax.ops.segment_min/max/sum``'s empty-segment fill.
   Push is legal only for min, max and integer add, so the combine is
   exact in any order.

Work is O(R + capacity·width) per superstep; the translator picks the
capacity tier from the live row count ``r_f`` (or the dense fallback).
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from . import _build
from .ref import _SCATTER_REDUCE, GATHER_OPS, PAD, REDUCE_OPS, gather_msg

_VALUE_DTYPES = {torch.float32: 1, torch.int32: 0}


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
    if values.device.type == "cpu":
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


def compacted_push_reduce(row_src, ell_dst, ell_wgt, live, values, degrees,
                          *, num_rows: int, capacity: int,
                          gather_fn: Callable, reduce: str, identity,
                          num_vertices: int, dtype: torch.dtype,
                          gather_module: str | None = None,
                          use_kernels: bool = False,
                          emit_touched: bool = False):
    """Compaction → messages → combine over a live-row mask.

    With ``use_kernels`` the message stage is the CUDA kernel, which
    evaluates menu gathers only; otherwise the plain version runs the
    program's own ``gather_fn``, as the JAX package's XLA path does.
    """
    if reduce not in REDUCE_OPS:
        raise ValueError(reduce)
    if use_kernels and gather_module is None:
        raise ValueError("the push message kernel needs a menu gather")
    sel, ok = compact_rows(live, num_rows, capacity)
    sel = sel.long()
    dst_blk = torch.where(ok[:, None], ell_dst[sel], PAD)   # (cap, W)
    wgt_blk = ell_wgt[sel]
    src_blk = row_src[sel]
    if use_kernels:
        msg = push_ell_message_block(dst_blk, wgt_blk, src_blk, values,
                                     degrees, gather=gather_module)
    else:
        msg = push_ell_message_block_plain(dst_blk, wgt_blk, src_blk, values,
                                           degrees, gather_fn=gather_fn)
    if isinstance(identity, torch.Tensor):
        identity = identity.item()
    valid = dst_blk != PAD
    segs = torch.where(valid, dst_blk, num_vertices).reshape(-1).long()
    flat = torch.where(valid, msg.to(dtype), identity).reshape(-1)
    table = torch.full((num_vertices + 1,), identity, dtype=dtype,
                       device=values.device)
    red = table.scatter_reduce_(0, segs, flat, _SCATTER_REDUCE[reduce],
                                include_self=True)[:num_vertices]
    touched = None
    if emit_touched:
        touched = torch.zeros((num_vertices + 1,), dtype=torch.uint8,
                              device=values.device).scatter_reduce_(
            0, segs, valid.reshape(-1).to(torch.uint8), "amax",
            include_self=True)[:num_vertices] != 0
    return red, touched
