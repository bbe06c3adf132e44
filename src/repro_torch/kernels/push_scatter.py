"""Chunk-streamed push scatter over forward COO (``layout='coo_chunks'``).

Counterpart of ``repro.kernels.push_scatter``: only frontier sources
scatter messages along their out-edges,

    red[dst]  ⊕=  gather(values[src], w, out_deg[src])     for src in frontier

over the forward COO cut into the scheduler's ``pipelines`` chunks.  It
serves the sparse backend, which builds no forward ELL, and a dense
program whose apply is not an identity fixpoint; the dense backend's
fixpoint programs take ``push_ell.py``'s compacted engine instead.

The JAX package skips a chunk with no active source through ``lax.cond``
on the device.  A host loop could only skip by reading that flag back,
one device→host sync per chunk, so this port processes every chunk: a
chunk with no live source scatters only identities, so the result is the
same, and the run loop keeps its one sync per superstep.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import segment_sum
from .ref import _SCATTER_REDUCE, PAD, scatter_settled


def push_scatter_reduce(
    dst_c,                   # (C, S) int32 destination ids, PAD-padded
    src_c,                   # (C, S) int32 source ids (0 in padded slots)
    wgt_c,                   # (C, S) edge weights
    values: torch.Tensor,    # (V,) vertex values
    degrees: torch.Tensor,   # (V,) out-degrees (the gather's third argument)
    active: torch.Tensor,    # (V,) bool frontier
    *,
    gather_fn: Callable,     # (src_value, weight, degree) -> message
    reduce: str,             # 'add' | 'min' | 'max'
    identity,                # folded reduce identity (value dtype)
    num_vertices: int,
    dtype: torch.dtype,
    emit_touched: bool = True,
    sorted_dst: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Chunk-streamed push scatter: ``(reduced (V,), touched (V,) bool)``.

    The chunks are the rows of the three ``(C, S)`` tensors or, as the
    sparse pull passes them, three equal-length sequences of 1-D slices.

    Each chunk's identity-masked messages land in an identity-filled
    ``(V,)`` table (``scatter_reduce_`` with ``include_self=True``), and,
    with ``emit_touched``, an amax scatter marks the touched table
    (``None`` otherwise: an identity-fixpoint apply never reads it).
    A float32 add over chunks whose destinations ascend (``sorted_dst``:
    the sparse pull's reverse COO) folds each chunk through kernel 4
    (``segment_sum.segment_reduce``) and adds the chunks' tables in chunk
    order instead: a scatter's atomics would sum a hub's messages in an
    order that changes from run to run.
    """
    if isinstance(identity, torch.Tensor):
        identity = identity.item()
    red = torch.full((num_vertices,), identity, dtype=dtype,
                     device=values.device)
    got = torch.zeros((num_vertices,), dtype=torch.uint8,
                      device=values.device) if emit_touched else None
    for dst, srcs, ws in zip(dst_c, src_c, wgt_c):
        valid = dst != PAD
        srcs = srcs.long()               # padded slots already hold 0
        live = valid & active[srcs]
        v = values[srcs]
        msg = gather_fn(v, ws.to(v.dtype), degrees[srcs])
        msg = torch.where(live, msg.to(dtype), identity)  # add: identity 0
        safe_dst = torch.where(valid, dst, 0).long()
        if sorted_dst and reduce == "add" and dtype == torch.float32:
            # PAD (past every vertex) is dropped by the segment reduce
            red += segment_sum.segment_reduce(dst, msg, num_vertices,
                                              reduce="add")
        elif reduce != "add" and dtype.is_floating_point:
            # a +0/-0 tie settled as the kernels settle it
            red = scatter_settled(red, 0, safe_dst, msg, reduce)
        else:
            red.scatter_reduce_(0, safe_dst, msg, _SCATTER_REDUCE[reduce],
                                include_self=True)
        if emit_touched:
            got.scatter_reduce_(0, safe_dst, live.to(torch.uint8), "amax",
                                include_self=True)
    return red, (got != 0) if emit_touched else None


def chunk_coo(dst, src, wgt, *, num_chunks: int):
    """Pad and reshape flat forward-COO tensors into ``(C, S)`` chunks:
    padded slots carry ``dst=PAD`` (the validity sentinel) and ``src=0``
    (a safe index)."""
    e = dst.shape[0]
    csize = -(-e // num_chunks)
    pad = num_chunks * csize - e
    fill = torch.nn.functional.pad
    return (fill(dst, (0, pad), value=PAD).reshape(num_chunks, csize),
            fill(src, (0, pad)).reshape(num_chunks, csize),
            fill(wgt, (0, pad)).reshape(num_chunks, csize))
