"""Graph data structures (the paper's "Graph data" layer, Fig. 3).

CSR (Vertices, Edge_offset, Edges) is the canonical format, as in
``repro.core.graph``.  The derived layouts the dense engine streams — the
degree-bucketed reversed ELL, its flat width-8 view (``PullBitmapPlan``)
and the forward ELL of the push engine — are built host-side with numpy
and held as frozen dataclasses of torch tensors; :func:`to_device` moves
one to the run's device.  Every builder produces arrays equal element for
element to the JAX package's (int32 storage, the same padding and order).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..errors import GraphValidationError

# Sentinel for padded edge slots.
PAD = 2**31 - 1

# Packed-bitmap word width: 32 vertices per word.
BITMAP_BITS = 32


def _np(t) -> np.ndarray:
    """Host numpy view of a tensor (or array-like)."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _tensor32(a) -> torch.Tensor:
    """numpy → CPU tensor with 64-bit types narrowed to 32 bits.

    The JAX package runs without 64-bit mode, so its arrays of host
    float64/int64 data are float32/int32; the port stores the same.
    """
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    if not a.flags.writeable:          # torch wants memory it may write
        a = a.copy()
    return torch.from_numpy(np.ascontiguousarray(a))


def to_device(obj, device):
    """``obj`` with every tensor on ``device``: a tensor, or a dataclass,
    tuple or list of them (a :class:`Graph` or a layout), copied."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(x, device) for x in obj)
    return obj


# ---------------------------------------------------------------------------
# Packed bitmap frontier.  PyTorch has no uint32 popcount, so words are
# int64 tensors holding the 32-bit patterns; counts use the SWAR popcount.
# ---------------------------------------------------------------------------


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """Pack a boolean mask into 32-bit words (bit ``i`` of word ``w`` is
    ``mask[32w + i]``), returned as int64 holding the uint32 pattern; a
    ``(k, n)`` batch packs each row."""
    *lead, n = mask.shape
    if n == 0:
        return torch.zeros((*lead, 1), dtype=torch.int64, device=mask.device)
    pad = (-n) % BITMAP_BITS
    b = torch.nn.functional.pad(mask.to(torch.int64), (0, pad))
    shifts = torch.arange(BITMAP_BITS, dtype=torch.int64, device=mask.device)
    return (b.reshape(*lead, -1, BITMAP_BITS) << shifts).sum(dim=-1)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: 32-bit words → ``(n,)`` bool mask."""
    shifts = torch.arange(BITMAP_BITS, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[:, None] >> shifts[None, :]) & 1
    return bits.reshape(-1)[:n].to(torch.bool)


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit counts (int32) of 32-bit patterns."""
    x = words.to(torch.int64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24 & 0x3F).to(torch.int32)


def select_bits(words: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Position of the ``ranks[i]``-th set bit inside ``words[i]``.

    Five-round binary search on popcounts of the low half of the window;
    callers guarantee ``ranks[i] < popcount(words[i])``.
    """
    w = words.to(torch.int64)
    k = ranks.to(torch.int64)
    pos = torch.zeros_like(k)
    for width in (16, 8, 4, 2, 1):
        low = popcount_words((w >> pos) & ((1 << width) - 1)).to(torch.int64)
        go_high = k >= low
        k = torch.where(go_high, k - low, k)
        pos = torch.where(go_high, pos + width, pos)
    return pos.to(torch.int32)


def bitmap_select(words: torch.Tensor, capacity: int,
                  num_items: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Indices of the first ``capacity`` set bits, in ascending order.

    Returns ``(idx (capacity,) int32, ok (capacity,) bool)``; ``idx`` is 0
    where ``ok`` is False (past the set-bit count, or past ``num_items``).
    """
    nw = words.shape[0]
    cum = torch.cumsum(popcount_words(words).to(torch.int64), dim=0)
    slots = torch.arange(1, capacity + 1, dtype=torch.int64,
                         device=words.device)
    wi = torch.searchsorted(cum, slots)
    ok = wi < nw
    wis = torch.where(ok, wi, 0)
    prev = torch.where(wis > 0, cum[torch.clamp_min(wis - 1, 0)], 0)
    rank = (slots - 1) - prev
    bit = select_bits(words[wis], torch.where(ok, rank, 0))
    idx = wis * BITMAP_BITS + bit
    if num_items is not None:
        ok = ok & (idx < num_items)
    return torch.where(ok, idx, 0).to(torch.int32), ok


def interval_live_counts(words: torch.Tensor,
                         cuts: torch.Tensor) -> torch.Tensor:
    """Per-interval set-bit counts of a packed bitmap, on its device.

    ``words`` holds the 32-bit patterns of :func:`pack_bits`, ``(nw,)``
    or a batch ``(k, nw)``; ``cuts`` is the ``(P+1,)`` vertex cut points
    (``0 = cuts[0] <= ... <= cuts[P] <= 32 * nw``).  Returns the int32
    count of set bits in each ``[cuts[i], cuts[i+1])``, ``(P,)`` or
    ``(k, P)``: one popcount cumsum over the words plus a masked partial
    word at each (possibly mid-word) cut, as in the JAX package.
    """
    nw = words.shape[-1]
    pop = popcount_words(words).to(torch.int64)
    cum = torch.nn.functional.pad(torch.cumsum(pop, dim=-1), (1, 0))
    c = cuts.to(device=words.device, dtype=torch.int64)
    w = c // BITMAP_BITS
    rem = c - w * BITMAP_BITS
    mask = torch.where(rem > 0, (1 << rem) - 1, 0)
    part = popcount_words(words[..., torch.clamp(w, max=nw - 1)] & mask)
    below = cum[..., torch.clamp(w, max=nw)] \
        + torch.where(w < nw, part.to(torch.int64), 0)
    return (below[..., 1:] - below[..., :-1]).to(torch.int32)


def edge_interval_cuts(out_degrees: np.ndarray, parts: int) -> np.ndarray:
    """Edge-balanced contiguous vertex cut points (host numpy).

    A ``(parts+1,)`` int64 array, ``cuts[0] == 0``, ``cuts[-1] == V``,
    monotone; interval ``i`` owns the out-edges of vertices
    ``[cuts[i], cuts[i+1])``.  Cuts fall on the cumulative out-degree at
    equal fractions of E, as in the JAX package; an interval may be empty
    on extreme skew (a hub owning more than E/parts edges).
    """
    if parts < 1:
        raise ValueError(f"parts must be >= 1, got {parts}")
    deg = np.asarray(out_degrees, np.int64)
    v = len(deg)
    cum = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=cum[1:])
    targets = cum[-1] * np.arange(1, parts, dtype=np.float64) / parts
    inner = np.searchsorted(cum[1:], targets, side="left") + 1
    cuts = np.concatenate([[0], np.clip(inner, 0, v), [v]])
    return np.maximum.accumulate(cuts).astype(np.int64)


def partition_coo(g: "Graph", lo: int, hi: int
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One source-vertex interval's edges as host COO ``(src, dst, wgt)``:
    the CSR's contiguous edge range ``offsets[lo]:offsets[hi]``, with
    global vertex ids."""
    offsets = _np(g.edge_offsets).astype(np.int64)
    e0, e1 = int(offsets[lo]), int(offsets[hi])
    deg = offsets[lo + 1:hi + 1] - offsets[lo:hi]
    src = np.repeat(np.arange(lo, hi, dtype=np.int32), deg)
    dst = _np(g.edges_dst)[e0:e1]
    wgt = _np(g.edge_weights)[e0:e1]
    return src, dst.astype(np.int32), wgt


# ---------------------------------------------------------------------------
# CSR graph and derived layouts
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Graph:
    """CSR graph. ``edge_offsets[v]:edge_offsets[v+1]`` index ``edges_dst``.

    ``vertex_values`` is the algorithm-owned per-vertex state.  The
    tensors live on one device (the CPU unless the caller moved them).
    """

    vertex_values: torch.Tensor     # (V,) algorithm state
    edge_offsets: torch.Tensor      # (V+1,) int32
    edges_dst: torch.Tensor         # (E,) int32 destination vertex ids
    edge_weights: torch.Tensor      # (E,) weights
    num_vertices: int
    num_edges: int

    @property
    def out_degrees(self) -> torch.Tensor:
        return self.edge_offsets[1:] - self.edge_offsets[:-1]


def graph_from_arrays(edge_offsets, edges_dst, edge_weights, vertex_values,
                      num_vertices: int, device=None) -> Graph:
    """The port's :class:`Graph` from host arrays of the same fields.

    Takes what ``np.asarray`` gives of a JAX ``Graph``'s fields, so a
    graph built by either package carries over unchanged.
    """
    device = torch.device(device or "cpu")
    dst = _tensor32(edges_dst)
    return Graph(
        vertex_values=_tensor32(vertex_values).to(device),
        edge_offsets=_tensor32(np.asarray(edge_offsets).astype(np.int32))
        .to(device),
        edges_dst=dst.to(torch.int32).to(device),
        edge_weights=_tensor32(edge_weights).to(device),
        num_vertices=int(num_vertices),
        num_edges=int(dst.shape[0]),
    )


def validate_graph(g: Graph, *, reduce: str | None = None) -> None:
    """Structural + integrity checks; raises :class:`GraphValidationError`.

    Offsets of length V+1 starting at 0, monotone, ending at E; every
    destination in ``[0, V)``; finite weights; and, for ``reduce='min'``
    (distance semantics), non-negative weights.
    """
    v, e = g.num_vertices, g.num_edges
    off = _np(g.edge_offsets)
    if off.shape != (v + 1,):
        raise GraphValidationError(
            f"edge_offsets has shape {off.shape}, expected ({v + 1},)")
    if off.size == 0 or off[0] != 0:
        raise GraphValidationError("edge_offsets must start at 0")
    if np.any(np.diff(off) < 0):
        bad = int(np.nonzero(np.diff(off) < 0)[0][0])
        raise GraphValidationError(
            f"edge_offsets not monotone at vertex {bad}: "
            f"{int(off[bad])} > {int(off[bad + 1])}")
    if int(off[-1]) != e:
        raise GraphValidationError(
            f"edge_offsets ends at {int(off[-1])}, expected num_edges={e}")
    dst = _np(g.edges_dst)
    if dst.shape != (e,):
        raise GraphValidationError(
            f"edges_dst has shape {dst.shape}, expected ({e},)")
    if e and (int(dst.min()) < 0 or int(dst.max()) >= v):
        bad = int(np.nonzero((dst < 0) | (dst >= v))[0][0])
        raise GraphValidationError(
            f"edges_dst[{bad}] = {int(dst[bad])} out of range [0, {v})")
    wgt = _np(g.edge_weights)
    if wgt.shape != (e,):
        raise GraphValidationError(
            f"edge_weights has shape {wgt.shape}, expected ({e},)")
    if e and not np.all(np.isfinite(wgt)):
        bad = int(np.nonzero(~np.isfinite(wgt))[0][0])
        raise GraphValidationError(
            f"edge_weights[{bad}] = {wgt[bad]} is not finite")
    if reduce == "min" and e and float(wgt.min()) < 0:
        bad = int(np.nonzero(wgt < 0)[0][0])
        raise GraphValidationError(
            f"reduce='min' (distance semantics) requires non-negative "
            f"weights; edge_weights[{bad}] = {wgt[bad]}")


def from_edge_list(
    src: np.ndarray,
    dst: np.ndarray,
    *,
    num_vertices: int | None = None,
    weights: np.ndarray | None = None,
    vertex_values: np.ndarray | None = None,
    sort: bool = True,
    validate: bool = False,
) -> Graph:
    """Build a CSR :class:`Graph` (CPU tensors) from COO edge lists."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    if num_vertices is None:
        num_vertices = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    if validate and len(src) and (
            int(src.min()) < 0 or int(src.max()) >= num_vertices):
        bad = int(np.nonzero((src < 0) | (src >= num_vertices))[0][0])
        raise GraphValidationError(
            f"src[{bad}] = {int(src[bad])} out of range "
            f"[0, {num_vertices})")
    e = len(src)
    if weights is None:
        weights = np.ones(e, np.float32)
    weights = np.asarray(weights)
    if sort:
        order = np.argsort(src, kind="stable")
        src, dst, weights = src[order], dst[order], weights[order]
    counts = np.bincount(src, minlength=num_vertices)
    offsets = np.zeros(num_vertices + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    if vertex_values is None:
        vertex_values = np.zeros(num_vertices, np.float32)
    g = Graph(
        vertex_values=_tensor32(vertex_values),
        edge_offsets=torch.from_numpy(offsets.astype(np.int32)),
        edges_dst=torch.from_numpy(dst),
        edge_weights=_tensor32(weights),
        num_vertices=num_vertices,
        num_edges=e,
    )
    if validate:
        validate_graph(g)
    return g


def to_coo(g: Graph) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR → host COO ``(src, dst, wgt)``."""
    offsets = _np(g.edge_offsets)
    degrees = offsets[1:] - offsets[:-1]
    src = np.repeat(np.arange(g.num_vertices, dtype=np.int32), degrees)
    return src, _np(g.edges_dst), _np(g.edge_weights)


def coo_arrays(g: Graph) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """COO ``(src, dst, wgt)`` of the CSR, on the graph's device: edge
    ``i``'s source is the ``v`` with ``offsets[v] <= i < offsets[v+1]``,
    found by ``searchsorted`` as in the JAX package (no host round trip)."""
    idx = torch.arange(g.num_edges, dtype=torch.int32,
                       device=g.edge_offsets.device)
    src = torch.searchsorted(g.edge_offsets[1:].contiguous(), idx,
                             right=True)
    return src.to(torch.int32), g.edges_dst, g.edge_weights


def reverse(g: Graph) -> Graph:
    """Transpose the graph (CSR ↔ CSC): out-edges become in-edges."""
    src, dst, w = to_coo(g)
    return from_edge_list(dst, src, num_vertices=g.num_vertices, weights=w,
                          vertex_values=_np(g.vertex_values))


@dataclasses.dataclass(frozen=True)
class BucketedGraph:
    """Degree-bucketed ELLPACK edge blocks.

    Bucket ``b`` stores its vertices' adjacency as a dense
    ``(rows_b, width_b)`` matrix padded with ``PAD``; ``src_ids`` maps
    bucket rows back to vertex ids.
    """

    src_ids: tuple        # tuple of (rows_b,) int32 tensors
    dst: tuple            # tuple of (rows_b, width_b) int32 tensors
    weights: tuple        # tuple of (rows_b, width_b) weight tensors
    num_vertices: int
    num_edges: int

    @property
    def num_buckets(self) -> int:
        return len(self.src_ids)


def bucketize(g: Graph, *, min_width: int = 8,
              max_width: int = 1024) -> BucketedGraph:
    """Re-block CSR into degree buckets of power-of-two ELL width.

    Each vertex with degree ``d`` goes to the smallest width ``>= d``; a
    hub above ``max_width`` splits into ``ceil(d/max_width)`` consecutive
    max-width rows.  Rows within a bucket are in vertex order — the same
    layout as ``repro.core.graph.bucketize``, built with array arithmetic
    instead of a loop over vertices.
    """
    offsets = _np(g.edge_offsets).astype(np.int64)
    dst = _np(g.edges_dst)
    wts = _np(g.edge_weights)
    degrees = offsets[1:] - offsets[:-1]

    widths = []
    w = min_width
    while w <= max_width:
        widths.append(w)
        w *= 2
    bucket_w = np.zeros(g.num_vertices, np.int64)
    for w in reversed(widths):
        bucket_w[(degrees > 0) & (degrees <= w)] = w
    bucket_w[degrees > max_width] = max_width

    src_ids, dsts, weights = [], [], []
    for w in widths:
        verts = np.nonzero(bucket_w == w)[0]
        if not len(verts):
            continue
        rows_v = -(-degrees[verts] // w)
        sid = np.repeat(verts, rows_v)
        first_row = np.zeros(len(verts) + 1, np.int64)
        np.cumsum(rows_v, out=first_row[1:])
        k = np.arange(len(sid)) - np.repeat(first_row[:-1], rows_v)
        start = offsets[sid] + k * w
        idx = start[:, None] + np.arange(w)[None, :]
        valid = idx < offsets[sid + 1][:, None]
        safe = np.where(valid, idx, 0)
        dm = np.where(valid, dst[safe].astype(np.int64), PAD)
        wm = np.where(valid, wts[safe], 0).astype(wts.dtype)
        src_ids.append(torch.from_numpy(sid.astype(np.int32)))
        dsts.append(torch.from_numpy(dm.astype(np.int32)))
        weights.append(torch.from_numpy(wm))
    return BucketedGraph(src_ids=tuple(src_ids), dst=tuple(dsts),
                         weights=tuple(weights),
                         num_vertices=g.num_vertices, num_edges=g.num_edges)


@dataclasses.dataclass(frozen=True)
class ForwardELL:
    """Fixed-width forward (out-edge) ELL rows, the push engine's layout.

    A vertex with out-degree ``d`` owns ``ceil(d / width)`` consecutive
    rows padded with ``PAD``; ``rows_per_vertex`` gives the live row count
    ``r_f = sum(rows_per_vertex[frontier])`` that picks a capacity tier.
    An edgeless graph keeps one all-PAD dummy row (``num_rows == 0``).
    """

    row_src: torch.Tensor           # (max(R,1),) int32 owner vertex per row
    dst: torch.Tensor               # (max(R,1), width) int32, PAD-padded
    weights: torch.Tensor           # (max(R,1), width) edge weights
    rows_per_vertex: torch.Tensor   # (V,) int32 ceil(out_deg / width)
    num_rows: int                   # logical R
    width: int
    num_vertices: int
    num_edges: int


def forward_ell(g: Graph, *, width: int = 8) -> ForwardELL:
    """Build the push engine's forward ELL from CSR (host-side numpy)."""
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    offsets = _np(g.edge_offsets).astype(np.int64)
    dst = _np(g.edges_dst)
    wts = _np(g.edge_weights)
    deg = offsets[1:] - offsets[:-1]
    rows_per_v = -(-deg // width)
    r = int(rows_per_v.sum())
    row_off = np.zeros(g.num_vertices + 1, np.int64)
    np.cumsum(rows_per_v, out=row_off[1:])
    row_src = np.repeat(np.arange(g.num_vertices, dtype=np.int32), rows_per_v)
    if r == 0:                                           # edgeless: dummy row
        return ForwardELL(
            row_src=torch.zeros((1,), dtype=torch.int32),
            dst=torch.full((1, width), PAD, dtype=torch.int32),
            weights=torch.from_numpy(np.zeros((1, width), wts.dtype)),
            rows_per_vertex=torch.zeros((g.num_vertices,), dtype=torch.int32),
            num_rows=0, width=width,
            num_vertices=g.num_vertices, num_edges=g.num_edges)
    base = offsets[row_src] + (np.arange(r) - row_off[row_src]) * width
    idx = base[:, None] + np.arange(width)[None, :]
    valid = idx < offsets[row_src + 1][:, None]
    safe = np.where(valid, idx, 0)
    ell_dst = np.where(valid, dst[safe].astype(np.int64), PAD)
    ell_wgt = np.where(valid, wts[safe], 0)
    return ForwardELL(
        row_src=torch.from_numpy(row_src),
        dst=torch.from_numpy(ell_dst.astype(np.int32)),
        weights=torch.from_numpy(ell_wgt.astype(wts.dtype)),
        rows_per_vertex=torch.from_numpy(rows_per_v.astype(np.int32)),
        num_rows=r, width=width,
        num_vertices=g.num_vertices, num_edges=g.num_edges)


@dataclasses.dataclass(frozen=True)
class PullBitmapPlan:
    """Static layout + combine metadata of the flat width-8 pull view.

    Every reversed-ELL bucket row re-flattens into ``W/8`` consecutive
    width-8 sub-rows (``flat_dst``/``flat_wgt``; ``owner8`` maps a sub-row
    to its vertex).  Sub-row reductions fold back to bucket rows by static
    per-bucket reshapes (``bucket_shapes``/``bucket_sub_offsets``) and to
    vertices through ``row_map`` plus the split-hub ``dup_rows`` scatter.
    The block fields serve the block-skipping plane: ``block_rows``
    consecutive sub-rows form a block, ``block_edges`` counts its real
    slots (the swept-edge accounting) and ``block_word_lo/hi`` bound its
    owners' bitmap words (the conservative range liveness).
    """

    flat_dst: torch.Tensor       # (R8p, 8) int32 destinations, PAD-padded
    flat_dst_safe: torch.Tensor  # (R8p, 8) int32, PAD baked to V
    flat_wgt: torch.Tensor       # (R8p, 8) edge weights
    owner8: torch.Tensor         # (R8p,) int32 owner vertex per sub-row
    row_map: torch.Tensor        # (V,) int32 → first concat row id
    dup_rows: torch.Tensor       # (max(D,1),) int32 concat rows beyond first
    dup_vertices: torch.Tensor   # (max(D,1),) int32 owner vertex per dup row
    block_edges: torch.Tensor    # (nb,) int32 real edge slots per block
    block_word_lo: torch.Tensor  # (nb,) int32 first owner bitmap word
    block_word_hi: torch.Tensor  # (nb,) int32 exclusive last owner word
    bucket_shapes: tuple         # (R_b, W_b/8)
    bucket_sub_offsets: tuple
    block_rows: int              # sub-rows per block
    num_blocks: int
    num_subrows: int             # R8p (padded)
    num_rows_total: int          # Σ R_b
    num_dup: int
    num_vertices: int


def pull_bitmap_plan(bucket: BucketedGraph, *,
                     block_slots: int = 64) -> PullBitmapPlan:
    """Build the flat pull view and its combine metadata (host-side)."""
    if block_slots < 8 or block_slots % 8:
        raise ValueError(f"block_slots must be a positive multiple of 8, "
                         f"got {block_slots}")
    V = bucket.num_vertices
    rows_per_bucket = [int(s.shape[0]) for s in bucket.src_ids]
    offsets = np.zeros(len(rows_per_bucket) + 1, np.int64)
    np.cumsum(rows_per_bucket, out=offsets[1:])
    r_cat = int(offsets[-1])

    row_map = np.full(V, r_cat, np.int64)
    dup_rows, dup_vertices = [], []
    flat_dst, flat_wgt, owner8 = [], [], []
    bucket_shapes, bucket_sub_offsets = [], []
    sub_off = 0
    wdtype = np.float32
    for b, (sid, dst, wgt) in enumerate(zip(bucket.src_ids, bucket.dst,
                                            bucket.weights)):
        sid, dst, wgt = _np(sid), _np(dst), _np(wgt)
        wdtype = wgt.dtype
        rows_b, width = dst.shape
        if width % 8:
            raise ValueError(f"bucket width {width} is not a multiple of 8")
        # a split hub's extra rows are consecutive, so the first row per
        # owner is a neighbor compare
        first = np.ones(rows_b, bool)
        first[1:] = sid[1:] != sid[:-1]
        rid = offsets[b] + np.arange(rows_b)
        row_map[sid[first]] = rid[first]
        dup_rows.append(rid[~first])
        dup_vertices.append(sid[~first].astype(np.int64))
        f_b = width // 8
        flat_dst.append(dst.reshape(rows_b * f_b, 8))
        flat_wgt.append(wgt.reshape(rows_b * f_b, 8))
        owner8.append(np.repeat(sid, f_b))
        bucket_shapes.append((rows_b, f_b))
        bucket_sub_offsets.append(sub_off)
        sub_off += rows_b * f_b

    br = block_slots // 8
    r8 = sub_off
    r8p = max(-(-r8 // br), 1) * br             # pad to whole blocks
    pad = r8p - r8
    fd = np.concatenate(flat_dst).astype(np.int64) if flat_dst else \
        np.zeros((0, 8), np.int64)
    fw = np.concatenate(flat_wgt) if flat_wgt else np.zeros((0, 8), wdtype)
    ow = np.concatenate(owner8).astype(np.int64) if owner8 else \
        np.zeros((0,), np.int64)
    fd = np.concatenate([fd, np.full((pad, 8), PAD, np.int64)])
    fw = np.concatenate([fw, np.zeros((pad, 8), fw.dtype)])
    ow = np.concatenate([ow, np.full(pad, V, np.int64)])

    nb = r8p // br
    edges = (fd != PAD).sum(axis=1).reshape(nb, br).sum(axis=1)
    ow_2d = ow.reshape(nb, br)
    real = ow_2d < V
    lo_ids = np.where(real, ow_2d, np.int64(V)).min(axis=1)
    hi_ids = np.where(real, ow_2d, np.int64(-1)).max(axis=1)

    dup_r = np.concatenate(dup_rows) if dup_rows else np.zeros(0, np.int64)
    dup_v = np.concatenate(dup_vertices) if dup_vertices else \
        np.zeros(0, np.int64)
    ndup = len(dup_r)
    if not ndup:
        dup_r = dup_v = np.zeros(1, np.int64)

    def i32(a):
        return torch.from_numpy(np.asarray(a).astype(np.int32))

    return PullBitmapPlan(
        flat_dst=i32(fd),
        flat_dst_safe=i32(np.where(fd == PAD, np.int64(V), fd)),
        flat_wgt=torch.from_numpy(np.ascontiguousarray(fw)),
        owner8=i32(ow),
        row_map=i32(row_map),
        dup_rows=i32(dup_r),
        dup_vertices=i32(dup_v),
        block_edges=i32(edges),
        block_word_lo=i32(np.where(lo_ids <= hi_ids,
                                   lo_ids // BITMAP_BITS, 0)),
        block_word_hi=i32(np.where(lo_ids <= hi_ids,
                                   hi_ids // BITMAP_BITS + 1, 0)),
        bucket_shapes=tuple(bucket_shapes),
        bucket_sub_offsets=tuple(bucket_sub_offsets),
        block_rows=br,
        num_blocks=nb,
        num_subrows=r8p,
        num_rows_total=r_cat,
        num_dup=ndup,
        num_vertices=V,
    )


def rmat_edges(
    num_vertices: int,
    num_edges: int,
    *,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> tuple[np.ndarray, np.ndarray]:
    """R-MAT power-law edge generator (Graph500-style), host-side numpy.

    The same numpy generator and draw order as ``repro.core.graph``, so a
    seed gives the same edges in both packages.
    """
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(num_vertices, 2))))
    src = np.zeros(num_edges, np.int64)
    dst = np.zeros(num_edges, np.int64)
    for level in range(scale):
        r = rng.random(num_edges)
        right = r > a + b          # falls in c or d quadrant → dst bit set
        down = ((r > a) & (r <= a + b)) | (r > a + b + c)  # b or d → src bit
        src |= down.astype(np.int64) << level
        dst |= right.astype(np.int64) << level
    src %= num_vertices
    dst %= num_vertices
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # top up dropped self-loops with uniform random edges
    missing = num_edges - len(src)
    if missing > 0:
        s2 = rng.integers(0, num_vertices, missing)
        d2 = (s2 + 1 + rng.integers(0, num_vertices - 1, missing)) % num_vertices
        src = np.concatenate([src, s2])
        dst = np.concatenate([dst, d2])
    return src.astype(np.int32), dst.astype(np.int32)
