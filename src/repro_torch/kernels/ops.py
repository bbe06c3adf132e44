"""Menu-name conveniences over the kernel modules.

Counterpart of ``repro.kernels.ops`` for tests and direct callers (the
translator stages the modules itself).  The kernel wrappers dispatch by
device on their own — ``edge_block.edge_block_reduce``,
``push_ell.push_ell_message_block``, ``push_ell.push_ell_fused_reduce``,
``segment_sum.segment_reduce`` and ``decode_gqa.decode_gqa`` take their
plain version for CPU tensors and launch their CUDA kernel for CUDA
tensors — so what is left here is argument plumbing: the touched summary
of the bitmap pull plane, the segment reduce (kernel 4's one entry point,
as in the JAX package), the two push reduces with the reduce identity
folded from the menu names, and the decode attention (kernel 5's entry
point, which the served model's decode step calls).
"""
from __future__ import annotations

from functools import partial

import torch

from . import decode_gqa as _decode_gqa
from . import pull_bitmap as _pull_bitmap
from . import push_ell as _push_ell
from . import push_scatter as _push_scatter
from . import ref as _ref
from . import segment_sum as _segment_sum


def touched_frontier(row_src, ell_dst, active, *, num_rows, capacity,
                     num_vertices):
    """The bitmap pull plane's ``(V+1,)`` uint8 touched table (see
    ``pull_bitmap.touched_table``)."""
    return _pull_bitmap.touched_table(
        row_src, ell_dst, active, num_rows=num_rows, capacity=capacity,
        num_vertices=num_vertices)


def segment_reduce(seg, val, num_segments, *, reduce="add"):
    """Segment add/min/max of a sorted stream: the CUDA kernel for CUDA
    tensors, its plain version for CPU ones."""
    return _segment_sum.segment_reduce(seg, val, num_segments, reduce=reduce)


def push_scatter_reduce(src, dst, wgt, values, degrees, active, *, gather,
                        reduce, mask_inactive=True, num_chunks=8):
    """Push-direction frontier scatter over flat forward-COO tensors,
    streamed in ``num_chunks`` chunks; returns ``(red, touched)`` as the
    dense oracle ``ref.push_scatter_reduce_ref`` does."""
    dst_c, src_c, wgt_c = _push_scatter.chunk_coo(dst, src, wgt,
                                                  num_chunks=num_chunks)
    if not mask_inactive:
        active = torch.ones_like(active)
    return _push_scatter.push_scatter_reduce(
        dst_c, src_c, wgt_c, values, degrees, active,
        gather_fn=partial(_ref.gather_msg, gather), reduce=reduce,
        identity=_ref._identity(reduce, values.dtype),
        num_vertices=values.shape[0], dtype=values.dtype)


def push_ell_reduce(row_src, ell_dst, ell_wgt, values, degrees, active, *,
                    num_rows, capacity, gather, reduce, mask_inactive=True,
                    emit_touched=True):
    """Frontier-compacted forward-ELL push reduce (menu-gather dispatch).

    The reduce identity is folded here and ``emit_touched`` defaults on,
    so the result matches ``ref.push_scatter_reduce_ref``; the messages
    and combine are the fused CUDA kernel exactly when the tensors are on
    a CUDA device.
    """
    if not mask_inactive:
        active = torch.ones_like(active)
    return _push_ell.push_ell_reduce(
        row_src, ell_dst, ell_wgt, values, degrees, active,
        num_rows=num_rows, capacity=capacity,
        gather_fn=partial(_ref.gather_msg, gather), reduce=reduce,
        identity=_ref._identity(reduce, values.dtype),
        num_vertices=values.shape[0], dtype=values.dtype,
        gather_module=gather, use_kernels=values.device.type == "cuda",
        emit_touched=emit_touched)


def decode_gqa(q, k_cache, v_cache, pos, length, *, scale=None,
               softcap=0.0):
    """One-query flash-decode GQA attention (see ``decode_gqa.py``): q
    ``(B, K, G, h)``, caches ``(B, S, K, h)``, ``pos`` ``(B, S)`` int32
    (−1 empty), ``length`` ``(B,)``, a nonzero ``softcap`` capping the
    scores; the CUDA kernel for CUDA tensors, its plain version for CPU
    ones.  The TPU tile ``block_s`` has no counterpart."""
    return _decode_gqa.decode_gqa(q, k_cache, v_cache, pos, length,
                                  scale=scale, softcap=softcap)
