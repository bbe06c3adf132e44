"""Combine cascade and message table of the flat width-8 pull view.

Counterpart of the parts of ``repro.kernels.pull_bitmap`` that the dense
pull sweep needs: :func:`subrow_combine` folds per-sub-row reductions back
to per-vertex values, and :func:`message_table` precomputes the masked
per-source messages of a weight-free gather.  The block-skipping plane
(touched summary, block liveness) is queued in ``ROADMAP.md``.
"""
from __future__ import annotations

from typing import Callable

import torch

from .ref import _identity, gather_msg, row_reduce


def combine_rows(row_red_cat: torch.Tensor, plan, identity, reduce: str,
                 dtype: torch.dtype) -> torch.Tensor:
    """Concatenated per-row reductions → (V,) table.

    ``row_red_cat`` holds the identity at index ``num_rows_total`` (the
    no-in-edge dummy ``row_map`` points at).  Split hubs (a vertex owning
    several max-width rows) fold their extra rows in with a small scatter
    over ``plan.dup_rows``.
    """
    red_v = row_red_cat[plan.row_map].to(dtype)
    if plan.num_dup:
        extra = row_red_cat[plan.dup_rows].to(dtype)
        idx = plan.dup_vertices.long()
        if reduce == "add":
            red_v = red_v.index_add(0, idx, extra)
        else:
            red_v = red_v.scatter_reduce(
                0, idx, extra, "amin" if reduce == "min" else "amax",
                include_self=True)
    return red_v


def subrow_combine(sub_red: torch.Tensor, plan, identity, reduce: str,
                   dtype: torch.dtype) -> torch.Tensor:
    """Flat sub-row reductions → (V,) table, with no per-edge scatter.

    Per bucket a static ``reshape(R_b, W_b/8)`` reduction folds sub-rows
    back to bucket rows (a vertex's sub-rows are consecutive, in lane
    order), then :func:`combine_rows` maps rows to vertices.  Pad
    sub-rows must hold the identity.
    """
    parts = []
    for (rows_b, f_b), off in zip(plan.bucket_shapes,
                                  plan.bucket_sub_offsets):
        seg = sub_red[off:off + rows_b * f_b]
        if f_b > 1:
            parts.append(row_reduce(reduce, seg.reshape(rows_b, f_b), 1))
        else:
            parts.append(seg)
    parts.append(torch.full((1,), identity, dtype=sub_red.dtype,
                            device=sub_red.device))
    return combine_rows(torch.cat(parts).to(dtype), plan, identity, reduce,
                        dtype)


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
