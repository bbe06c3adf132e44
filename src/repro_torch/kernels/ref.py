"""Plain PyTorch oracles for the kernel library (allclose/equal targets).

Counterpart of ``repro.kernels.ref``: the gather menu, the reduce
identities, and the dense edge-block and push-scatter reductions written
as straightforward tensor code.  The CUDA kernels are held against these
on the card, and the CPU tests hold these against the JAX package.
"""
from __future__ import annotations

import torch

PAD = torch.iinfo(torch.int32).max

# Static gather-op menu: the translator maps DSL gathers onto these
# pre-built module configurations.
GATHER_OPS = ("copy", "plus_one", "add_w", "mul_w", "div_deg")
REDUCE_OPS = ("add", "min", "max")

# Menu gathers whose message ignores the edge weight (pinned regression
# oracle for the analyzer's weight-use probe).
WEIGHT_FREE_GATHERS = ("copy", "plus_one", "div_deg")

_SCATTER_REDUCE = {"add": "sum", "min": "amin", "max": "amax"}

_ROW_REDUCE = {"add": lambda x, dim: torch.sum(x, dim=dim, dtype=x.dtype),
               "min": torch.amin, "max": torch.amax}


def _identity(reduce: str, dtype: torch.dtype):
    """The reduce identity for ``dtype`` as a Python scalar."""
    if not dtype.is_floating_point:
        info = torch.iinfo(dtype)
        return {"add": 0, "min": info.max, "max": info.min}[reduce]
    return {"add": 0.0, "min": float("inf"), "max": float("-inf")}[reduce]


def gather_msg(gather: str, v, w, d):
    """Evaluate a menu gather op: (src_value, weight, degree) → message."""
    if gather == "copy":
        return v
    if gather == "plus_one":
        return v + 1
    if gather == "add_w":
        return v + w
    if gather == "mul_w":
        return v * w
    if gather == "div_deg":
        return v / torch.clamp_min(d, 1).to(v.dtype)
    raise ValueError(gather)


def row_reduce(reduce: str, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Reduce along ``dim`` with add/min/max; min and max propagate NaN."""
    return _ROW_REDUCE[reduce](x, dim=dim)


def edge_block_messages(
    nbr: torch.Tensor,        # (R, W) int32 neighbor ids, PAD-padded
    wgt: torch.Tensor,        # (R, W) edge weights
    values: torch.Tensor,     # (V,) vertex values
    degrees: torch.Tensor,    # (V,) out-degrees (for div_deg)
    active: torch.Tensor,     # (V,) bool frontier
    *,
    gather: str,
    reduce: str,
    mask_inactive: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (messages (R, W), live (R, W) bool); a slot that is not
    live holds the reduce identity."""
    valid = nbr != PAD
    safe = torch.where(valid, nbr, 0)
    v = values[safe]
    d = degrees[safe]
    msg = gather_msg(gather, v, wgt.to(v.dtype), d)
    live = valid
    if mask_inactive:
        live = live & active[safe]
    return torch.where(live, msg, _identity(reduce, msg.dtype)), live


def edge_block_reduce_ref(
    nbr: torch.Tensor,        # (R, W) int32 neighbor ids, PAD-padded
    wgt: torch.Tensor,        # (R, W) edge weights
    values: torch.Tensor,     # (V,) vertex values
    degrees: torch.Tensor,    # (V,) out-degrees (for div_deg)
    active: torch.Tensor,     # (V,) bool frontier
    *,
    gather: str,
    reduce: str,
    mask_inactive: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (reduced (R,), any_active (R,) bool); a float min/max's
    tied zeros settled as :func:`settle_zero_ties` says."""
    msg, live = edge_block_messages(nbr, wgt, values, degrees, active,
                                    gather=gather, reduce=reduce,
                                    mask_inactive=mask_inactive)
    red = row_reduce(reduce, msg, 1)
    if reduce != "add" and red.dtype.is_floating_point:
        red = settle_zero_ties(red, zero_wins(msg, reduce).any(1), reduce)
    return red, torch.any(live, dim=1)


def zero_wins(msg: torch.Tensor, reduce: str) -> torch.Tensor:
    """Where a float min's (max's) message is the zero that wins a tie of
    +0 and -0: -0 for a min, +0 for a max."""
    return (msg == 0) & (torch.signbit(msg) == (reduce == "min"))


def settle_zero_ties(red: torch.Tensor, wins: torch.Tensor,
                     reduce: str) -> torch.Tensor:
    """A float min/max table's zeros as the CUDA kernels' combines settle
    a +0/-0 tie in any order (the order -0 < +0): where ``red`` is a zero,
    the winning zero if ``wins`` (a message of it reached the entry), else
    the other.  torch's reductions leave the sign of a tied zero to their
    order.  Integer tables and add come back as they were."""
    if reduce == "add" or not red.dtype.is_floating_point:
        return red
    win = torch.tensor(-0.0 if reduce == "min" else 0.0, dtype=red.dtype,
                       device=red.device)
    return torch.where(red == 0, torch.where(wins, win, -win), red)


def combine_settled(a: torch.Tensor, b: torch.Tensor,
                    reduce: str) -> torch.Tensor:
    """The kernels' elementwise combine of two tables (``gather_ops.cuh``'s
    ``combine``): add (int32 wraps), or min/max propagating NaN with a
    +0/-0 tie settled as :func:`settle_zero_ties` says."""
    if reduce == "add":
        return a + b
    out = torch.minimum(a, b) if reduce == "min" else torch.maximum(a, b)
    return settle_zero_ties(out, zero_wins(a, reduce) | zero_wins(b, reduce),
                            reduce)


def push_scatter_reduce_ref(
    src: torch.Tensor,        # (E,) int32 source vertex ids (forward COO)
    dst: torch.Tensor,        # (E,) int32 destination vertex ids
    wgt: torch.Tensor,        # (E,) edge weights
    values: torch.Tensor,     # (V,) vertex values
    degrees: torch.Tensor,    # (V,) out-degrees
    active: torch.Tensor,     # (V,) bool frontier
    *,
    gather: str,
    reduce: str,
    mask_inactive: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Push-direction oracle: scatter frontier messages over out-edges.

    Dense over all E edges with inactive sources masked to the identity.
    Returns ``(reduced (V,), touched (V,))``.
    """
    V = values.shape[0]
    src = src.long()
    dst = dst.long()
    v = values[src]
    d = degrees[src]
    msg = gather_msg(gather, v, wgt.to(v.dtype), d)
    live = active[src] if mask_inactive else torch.ones_like(src, dtype=bool)
    ident = _identity(reduce, msg.dtype)
    msg = torch.where(live, msg, ident)
    red = torch.full((V,), ident, dtype=msg.dtype, device=values.device)
    if reduce == "add":
        red = red.index_add(0, dst, torch.where(live, msg, 0))
    else:
        red = red.scatter_reduce(0, dst, msg, "amin" if reduce == "min"
                                 else "amax", include_self=True)
    got = torch.zeros((V,), dtype=torch.uint8,
                      device=values.device).scatter_reduce(
        0, dst, live.to(torch.uint8), "amax", include_self=True) != 0
    return red, got


def segment_reduce_ref(
    seg: torch.Tensor,        # (E,) int32 segment (receiving vertex) ids
    val: torch.Tensor,        # (E,) messages
    num_segments: int,
    *,
    reduce: str = "add",
) -> torch.Tensor:
    """Segment add/min/max into ``(num_segments,)``.

    An empty segment holds the reduce identity (``+inf``/``-inf`` for
    float min/max, ``iinfo.max``/``iinfo.min`` for int32, 0 for add), as
    ``jax.ops.segment_*`` and the Pallas kernel give; ids outside
    ``[0, num_segments)`` (the padded tail's ``INT_MAX``) are dropped.
    Min and max propagate NaN.
    """
    if reduce not in _SCATTER_REDUCE:
        raise ValueError(reduce)
    ident = _identity(reduce, val.dtype)
    seg = seg.long()
    valid = (seg >= 0) & (seg < num_segments)
    idx = torch.where(valid, seg, num_segments)
    table = torch.full((num_segments + 1,), ident, dtype=val.dtype,
                       device=val.device)
    return table.scatter_reduce_(0, idx, val, _SCATTER_REDUCE[reduce],
                                 include_self=True)[:num_segments]


def decode_gqa_ref(
    q: torch.Tensor,          # (B, K, G, h) one query step, grouped heads
    k_cache: torch.Tensor,    # (B, S, K, h)
    v_cache: torch.Tensor,    # (B, S, K, h)
    pos: torch.Tensor,        # (B, S) int32 cached positions (−1 = empty)
    length: torch.Tensor,     # (B,) valid cache lengths
    *,
    scale: float | None = None,
) -> torch.Tensor:            # (B, K, G, h) in q's dtype
    """One-query GQA attention over a cache, in float32: scores masked with
    ``-inf`` outside ``slot < length & pos >= 0``, softmax, PV product,
    cast to ``q.dtype``.  A masked slot's value row is zeroed before the
    product, so a NaN there cannot reach the output (the JAX oracle lets
    ``0 * NaN`` through); elsewhere this is ``repro.kernels.ref.
    decode_gqa_ref``.  A row with no valid slot gives NaN."""
    B, S, K, H = k_cache.shape
    scale = scale if scale is not None else H ** -0.5
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), k_cache.float()) * scale
    mask = (torch.arange(S, device=q.device)[None, :] < length[:, None]) \
        & (pos >= 0)
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    v = v_cache.float().masked_fill(~mask[:, :, None, None], 0.0)
    return torch.einsum("bkgs,bskh->bkgh", p, v).to(q.dtype)
