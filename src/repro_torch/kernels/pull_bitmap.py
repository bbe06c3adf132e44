"""Bitmap-frontier pull plane over the flat width-8 pull view.

Counterpart of ``repro.kernels.pull_bitmap``, in plain PyTorch (none of
these is a TPU kernel):

* :func:`touched_table` — which vertices have an active in-neighbor: a
  compacted forward scatter of frontier bits over the forward ELL;
* :func:`block_liveness` — exact per-block liveness (any owner touched),
  and :func:`block_range_live` / :func:`word_prefix`, the conservative
  word-range form over the packed touched bitmap;
* :func:`grid_block_live` — the kernel path's ``block_live`` flags, one
  per grid block of sub-rows (a lane or a ``(k, ·)`` batch of lanes);
* :func:`subrow_combine` — per-sub-row reductions back to per-vertex
  values, scatter-free but for split hubs, one lane or a ``(k, R8)``
  batch of lanes;
* :func:`message_table` — the masked per-source messages of a
  weight-free gather.

The translator's bitmap plane (``translator._emit_pull_bitmap``) builds
on these; its kernel path skips dead blocks inside
``edge_block.edge_block_reduce(block_live=...)``, and its batched
superstep (``translator._emit_lane_step``) inside the lane kernels'
``block_words=`` (2L), words built on the card by
``edge_block.lane_block_words`` from touched tables of
``push_ell.push_lanes_touched``; :func:`grid_block_live` is those
words' plain version.
"""
from __future__ import annotations

from typing import Callable

import torch

from .push_ell import compact_rows
from .ref import (PAD, _identity, gather_msg, row_reduce_settled,
                  scatter_settled)


def touched_table(row_src: torch.Tensor, ell_dst: torch.Tensor,
                  active: torch.Tensor, *, num_rows: int, capacity: int,
                  num_vertices: int) -> torch.Tensor:
    """Per-superstep any-active summary: ``(V+1,)`` uint8, 1 where a
    vertex has at least one active in-neighbor.

    Live forward-ELL rows compact into ``capacity`` slots and their
    destinations mark the table with an amax scatter; PAD destinations
    write 0 into the dummy slot ``V``, which so stays 0.  Correct only
    while ``capacity`` covers the live row count (the translator routes
    on ``m_f``, which bounds it).
    """
    live = active[row_src.long()]
    if num_rows == 0:
        live = torch.zeros_like(live)
    sel, ok = compact_rows(live, num_rows, capacity)
    dst_blk = torch.where(ok[:, None], ell_dst[sel.long()], PAD)
    valid = dst_blk != PAD
    idx = torch.where(valid, dst_blk, num_vertices).reshape(-1).long()
    table = torch.zeros((num_vertices + 1,), dtype=torch.uint8,
                        device=active.device)
    return table.scatter_reduce_(0, idx, valid.reshape(-1).to(torch.uint8),
                                 "amax", include_self=True)


def block_liveness(touched_u8: torch.Tensor, sid_blocked: torch.Tensor,
                   block_rows: int) -> torch.Tensor:
    """Exact per-block liveness: any sub-row owner touched (pad owners
    are ``V`` and read the table's always-zero dummy slot).  A ``(k,
    V+1)`` table of k lanes gives ``(k, blocks)``."""
    t = touched_u8[..., sid_blocked.long()] != 0
    return t.reshape(*t.shape[:-1], -1, block_rows).any(dim=-1)


def grid_block_live(touched_u8: torch.Tensor, owner8: torch.Tensor,
                    grid_rows: int) -> torch.Tensor:
    """``block_live`` flags for ``edge_block_reduce``: per grid block of
    ``grid_rows`` sub-rows (the last one ragged), any owner touched.

    A ``(k, V)`` or ``(k, V+1)`` table of k lanes gives the ``(k, grid
    blocks)`` flags of the lane kernels (the plain versions'
    ``block_live=``; the plain version of ``edge_block.lane_block_words``,
    which builds them on the card): the lanes go in groups of 8, a
    vertex's 8 flags one int64 word, so a sub-row's owner gathers one word
    a group, not a byte a lane; pad owners read a zero word past the
    table.
    """
    idx = owner8.long()
    pad = (-idx.shape[0]) % grid_rows
    if touched_u8.dim() == 1:
        t8 = touched_u8[idx] != 0
        return torch.cat([t8, t8.new_zeros(pad)]).reshape(-1, grid_rows) \
            .any(1)
    lanes, nv = touched_u8.shape
    if pad:
        idx = torch.cat([idx, idx.new_full((pad,), nv)])
    groups = -(-lanes // 8)
    t = torch.zeros((groups * 8, nv + 1), dtype=torch.bool,
                    device=touched_u8.device)
    t[:lanes, :nv] = touched_u8 if touched_u8.dtype == torch.bool \
        else touched_u8 != 0
    words = t.view(groups, 8, nv + 1).transpose(1, 2).contiguous() \
        .view(torch.int64).view(groups, nv + 1)
    live = words.index_select(1, idx).view(torch.bool) \
        .view(groups, -1, grid_rows, 8).any(2)
    return live.transpose(1, 2).reshape(groups * 8, -1)[:lanes].contiguous()


def block_range_live(word_prefix: torch.Tensor, word_lo: torch.Tensor,
                     word_hi: torch.Tensor) -> torch.Tensor:
    """Conservative liveness: the block's owner word interval holds a set
    bit (``word_prefix`` from :func:`word_prefix`).  Never misses a live
    block; may keep a dead one."""
    return (word_prefix[word_hi.long()] - word_prefix[word_lo.long()]) > 0


def word_prefix(words: torch.Tensor) -> torch.Tensor:
    """Exclusive popcount prefix over bitmap words, ``(nw+1,)`` int32."""
    from ..core.graph import popcount_words   # core imports this package
    c = popcount_words(words)
    return torch.cat([torch.zeros((1,), dtype=torch.int32,
                                  device=words.device),
                      torch.cumsum(c, dim=0).to(torch.int32)])


def combine_rows(row_red_cat: torch.Tensor, plan, identity, reduce: str,
                 dtype: torch.dtype) -> torch.Tensor:
    """Concatenated per-row reductions → (V,) table, or with a leading lane
    axis ``(k, rows + 1)`` → ``(k, V)``.

    ``row_red_cat`` holds the identity at index ``num_rows_total`` (the
    no-in-edge dummy ``row_map`` points at).  Split hubs (a vertex owning
    several max-width rows) fold their extra rows in with a small scatter
    over ``plan.dup_rows``.
    """
    if row_red_cat.dim() == 2 and reduce == "add" \
            and row_red_cat.dtype.is_floating_point:
        return torch.stack([combine_rows(row, plan, identity, reduce, dtype)
                            for row in row_red_cat])
    red_v = row_red_cat[..., plan.row_map].to(dtype)
    if plan.num_dup:
        extra = row_red_cat[..., plan.dup_rows].to(dtype)
        idx = plan.dup_vertices.long()
        if red_v.dim() == 1 and reduce == "add":
            # sequential on the CPU and sort-based on CUDA: a float sum
            # folds a hub's rows in one fixed order on every run
            red_v = red_v.index_put((idx,), extra, accumulate=True)
        elif reduce == "add":           # integer lanes: order-free
            red_v = red_v.scatter_add(1, idx.expand(red_v.shape[0], -1),
                                      extra)
        else:
            if red_v.dim() == 2:
                idx = idx.expand(red_v.shape[0], -1)
            red_v = scatter_settled(red_v, red_v.dim() - 1, idx, extra,
                                    reduce)
    return red_v


def subrow_combine(sub_red: torch.Tensor, plan, identity, reduce: str,
                   dtype: torch.dtype) -> torch.Tensor:
    """Flat sub-row reductions → (V,) table, with no per-edge scatter.

    Per bucket a static ``reshape(R_b, W_b/8)`` reduction folds sub-rows
    back to bucket rows (a vertex's sub-rows are consecutive, in lane
    order), then :func:`combine_rows` maps rows to vertices.  Pad
    sub-rows must hold the identity.

    ``sub_red`` may carry a leading lane axis, ``(k, R8)`` → ``(k, V)``:
    min, max and integer add fold all lanes at once (order-free); a float
    add folds each lane through the single-lane path, so each lane sums
    in the order one lane alone would.
    """
    if sub_red.dim() == 2:
        if reduce == "add" and sub_red.dtype.is_floating_point:
            return torch.stack([subrow_combine(row, plan, identity, reduce,
                                               dtype) for row in sub_red])
        lead = (sub_red.shape[0],)
    else:
        lead = ()
    parts = []
    for (rows_b, f_b), off in zip(plan.bucket_shapes,
                                  plan.bucket_sub_offsets):
        seg = sub_red[..., off:off + rows_b * f_b]
        if f_b > 1:
            parts.append(row_reduce_settled(
                reduce, seg.reshape(*lead, rows_b, f_b), -1))
        else:
            parts.append(seg)
    parts.append(torch.full((*lead, 1), identity, dtype=sub_red.dtype,
                            device=sub_red.device))
    return combine_rows(torch.cat(parts, dim=-1).to(dtype), plan, identity,
                        reduce, dtype)


def message_table(values: torch.Tensor, degrees: torch.Tensor,
                  active: torch.Tensor, *, gather: str | None,
                  gather_fn: Callable | None, reduce: str,
                  mask_inactive: bool, dtype: torch.dtype) -> torch.Tensor:
    """Per-source message table for weight-free gathers: ``(V+1,)`` with
    messages masked to the reduce identity for inactive sources and the
    identity in the PAD slot (index V)."""
    ones = torch.ones_like(values)       # the unread weight argument
    if gather is not None:
        msg = gather_msg(gather, values, ones, degrees)
    else:
        msg = gather_fn(values, ones, degrees)
    ident = _identity(reduce, dtype)
    msg = msg.to(dtype)
    if mask_inactive:
        msg = torch.where(active, msg, ident)
    return torch.cat([msg, torch.full((1,), ident, dtype=dtype,
                                      device=values.device)])
