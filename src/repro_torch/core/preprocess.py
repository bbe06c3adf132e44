"""Preprocessing library (paper §IV-C): FIFO and Layout, host-side.

Counterpart of ``repro.core.preprocess``: edge-list I/O, the paper-sized
synthetic graphs, the graph-keyed cache of derived layouts that
``translate`` reads (with its byte budget), and the streamed engine's
:class:`PartitionStore`, a byte-budgeted LRU of per-partition ELL
layouts held in pinned host memory when the run is on CUDA.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time

import numpy as np
import torch

from ..kernels import push_scatter
from . import graph as G

# ---------------------------------------------------------------------------
# FIFO — file I/O
# ---------------------------------------------------------------------------


def read_edge_list(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read SNAP-style 'src dst' text or .npz edge files."""
    if path.endswith(".npz"):
        z = np.load(path)
        return z["src"].astype(np.int32), z["dst"].astype(np.int32)
    src, dst = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(("#", "%")):
                continue
            a, b = line.split()[:2]
            src.append(int(a))
            dst.append(int(b))
    return np.asarray(src, np.int32), np.asarray(dst, np.int32)


def write_edge_list(path: str, src: np.ndarray, dst: np.ndarray) -> None:
    if path.endswith(".npz"):
        np.savez_compressed(path, src=src, dst=dst)
        return
    with open(path, "w") as f:
        for a, b in zip(src, dst):
            f.write(f"{int(a)} {int(b)}\n")


# ---------------------------------------------------------------------------
# Graph-keyed layout cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GraphLayouts:
    """Lazily built derived layouts for one graph, shared across translates.

    Each product is built once on host (numpy → CPU tensors) and, per
    device, copied there once (:meth:`on`).  ``build_times_s`` records the
    host seconds spent building each product.
    """

    graph: G.Graph                      # strong ref: keeps the id-key valid
    build_times_s: dict = dataclasses.field(default_factory=dict)
    _reverse: G.Graph | None = None
    _reverse_bucketed: G.BucketedGraph | None = None
    _reverse_coo: tuple | None = None
    _forward_coo_chunks: dict = dataclasses.field(default_factory=dict)
    _forward_ell: dict = dataclasses.field(default_factory=dict)
    _forward_ell_shards: dict = dataclasses.field(default_factory=dict)
    _pull_plan: dict = dataclasses.field(default_factory=dict)
    _on_device: dict = dataclasses.field(default_factory=dict)

    def _timed(self, name: str, build):
        # record self time: a nested build books its own entry
        t0 = time.perf_counter()
        children_before = sum(self.build_times_s.values())
        out = build()
        child_s = sum(self.build_times_s.values()) - children_before
        self.build_times_s[name] = time.perf_counter() - t0 - child_s
        return out

    def reverse(self) -> G.Graph:
        """Transposed CSR: pull's in-edge view."""
        if self._reverse is None:
            self._reverse = self._timed("reverse",
                                        lambda: G.reverse(self.graph))
        return self._reverse

    def reverse_bucketed(self) -> G.BucketedGraph:
        """Degree-bucketed ELL of the transposed graph."""
        if self._reverse_bucketed is None:
            self._reverse_bucketed = self._timed(
                "reverse_bucketed", lambda: G.bucketize(self.reverse()))
        return self._reverse_bucketed

    def reverse_coo(self) -> tuple:
        """``(dst, src, wgt)`` COO of the transposed graph (sparse pull):
        sorted by receiving vertex ``dst``."""
        if self._reverse_coo is None:
            self._reverse_coo = self._timed(
                "reverse_coo", lambda: G.coo_arrays(self.reverse()))
        return self._reverse_coo

    def forward_coo_chunks(self, num_chunks: int) -> tuple:
        """``(dst_c, src_c, wgt_c)`` forward-COO edge chunks of the
        chunk-streamed push scatter (``coo_chunks``), keyed per chunk
        count; only the chunked form is kept."""
        if num_chunks not in self._forward_coo_chunks:
            def build():
                src, dst, wgt = G.coo_arrays(self.graph)
                return push_scatter.chunk_coo(dst, src, wgt,
                                              num_chunks=num_chunks)
            self._forward_coo_chunks[num_chunks] = self._timed(
                f"forward_coo_chunks_c{num_chunks}", build)
        return self._forward_coo_chunks[num_chunks]

    def pull_plan(self, block_slots: int = 64) -> G.PullBitmapPlan:
        """The flat width-8 pull view, keyed per ``block_slots``."""
        if block_slots not in self._pull_plan:
            rb = self.reverse_bucketed()
            self._pull_plan[block_slots] = self._timed(
                f"pull_plan_s{block_slots}",
                lambda: G.pull_bitmap_plan(rb, block_slots=block_slots))
        return self._pull_plan[block_slots]

    def forward_ell(self, width: int = 8) -> G.ForwardELL:
        """Fixed-width forward ELL (the compacted push engine's layout)."""
        if width not in self._forward_ell:
            self._forward_ell[width] = self._timed(
                f"forward_ell_w{width}",
                lambda: G.forward_ell(self.graph, width=width))
        return self._forward_ell[width]

    def forward_ell_shards(self, width: int, pes: int
                           ) -> G.ShardedForwardELL:
        """Per-PE row-interval partition of the forward ELL (multi-PE
        push), keyed per ``(width, pes)``, so an elastic re-plan onto
        another PE count partitions once and then hits the cache."""
        key = (width, pes)
        if key not in self._forward_ell_shards:
            fe = self.forward_ell(width)
            self._forward_ell_shards[key] = self._timed(
                f"forward_ell_shards_w{width}_p{pes}",
                lambda: G.shard_forward_ell(fe, pes))
        return self._forward_ell_shards[key]

    def on_pe(self, shards: G.ShardedForwardELL, p: int, device) -> tuple:
        """PE ``p``'s interval of ``shards`` (a product of this cache),
        :meth:`~repro_torch.core.graph.ShardedForwardELL.interval`, on
        ``device``: only that PE's rows are copied, once per device."""
        key = ("pe", id(shards), p, str(device))
        if key not in self._on_device:
            self._on_device[key] = (shards, tuple(
                t.to(device) for t in shards.interval(p)))
        return self._on_device[key][1]

    def on(self, layout, device):
        """``layout`` (a product of this cache) with its tensors on
        ``device``, copied once per device."""
        key = (id(layout), str(device))
        if key not in self._on_device:
            self._on_device[key] = (layout, G.to_device(layout, device))
        return self._on_device[key][1]

    def nbytes(self) -> int:
        """Bytes of the derived host products (the base graph and the
        device copies excluded); shared buffers count once per holder, an
        upper bound, the right direction for a budget."""
        products = [self._reverse, self._reverse_bucketed, self._reverse_coo,
                    *self._forward_coo_chunks.values(),
                    *self._forward_ell.values(),
                    *self._forward_ell_shards.values(),
                    *self._pull_plan.values()]
        return sum(_product_nbytes(p) for p in products if p is not None)

    def stats(self) -> dict:
        """Resident bytes, and what was built and for how long."""
        return {"resident_bytes": self.nbytes(),
                "products": sorted(self.build_times_s),
                "build_times_s": dict(self.build_times_s)}


def _product_nbytes(obj) -> int:
    """Bytes of every tensor or array reachable from a layout product
    (dataclasses, tuples, lists and dicts are walked)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, np.ndarray):
        return int(obj.nbytes)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(_product_nbytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return sum(_product_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_product_nbytes(v) for v in obj)
    return 0


_LAYOUT_CACHE: collections.OrderedDict = collections.OrderedDict()
_LAYOUT_CACHE_MAX = 8
_LAYOUT_CACHE_MAX_BYTES: int | None = None
_layout_cache_hits = 0
_layout_cache_misses = 0
_layout_cache_evictions = 0


def _layout_key(g: G.Graph) -> tuple:
    return (id(g.edge_offsets), id(g.edges_dst), id(g.edge_weights),
            g.num_vertices, g.num_edges)


def layouts_for(g: G.Graph) -> GraphLayouts:
    """Memoized :class:`GraphLayouts` for ``g``, keyed on the identity of
    its structure tensors; an entry holds those tensors, so an id cannot
    be recycled while the entry lives."""
    global _layout_cache_hits, _layout_cache_misses
    key = _layout_key(g)
    hit = _LAYOUT_CACHE.get(key)
    if hit is not None and hit.graph.edges_dst is g.edges_dst \
            and hit.graph.edge_offsets is g.edge_offsets \
            and hit.graph.edge_weights is g.edge_weights:
        _LAYOUT_CACHE.move_to_end(key)
        _layout_cache_hits += 1
        # entries grow after insertion: re-check the byte budget
        _enforce_layout_budget(keep=key)
        return hit
    entry = GraphLayouts(graph=g)
    _LAYOUT_CACHE[key] = entry
    _LAYOUT_CACHE.move_to_end(key)
    _enforce_layout_budget(keep=key)
    _layout_cache_misses += 1
    return entry


def _enforce_layout_budget(keep: tuple | None = None) -> None:
    """Evict least recently used entries past the entry cap or the byte
    budget; ``keep`` (the entry just inserted or hit) stays, so one graph
    larger than the budget still translates."""
    global _layout_cache_evictions

    def over() -> bool:
        if len(_LAYOUT_CACHE) > _LAYOUT_CACHE_MAX:
            return True
        return (_LAYOUT_CACHE_MAX_BYTES is not None
                and layout_cache_resident_bytes() > _LAYOUT_CACHE_MAX_BYTES)

    while over():
        victim = next((k for k in _LAYOUT_CACHE if k != keep), None)
        if victim is None:
            break
        del _LAYOUT_CACHE[victim]
        _layout_cache_evictions += 1


def set_layout_cache_limit(max_bytes: int | None, *,
                           max_entries: int | None = None) -> None:
    """Set the layout cache's byte budget (``None``: unbounded) and,
    optionally, its entry cap; both are enforced at once."""
    global _LAYOUT_CACHE_MAX, _LAYOUT_CACHE_MAX_BYTES
    if max_bytes is not None and max_bytes < 0:
        raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
    _LAYOUT_CACHE_MAX_BYTES = max_bytes
    if max_entries is not None:
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        _LAYOUT_CACHE_MAX = max_entries
    _enforce_layout_budget()


def layout_cache_resident_bytes() -> int:
    """Derived-product bytes held across all cached layouts."""
    return sum(e.nbytes() for e in _LAYOUT_CACHE.values())


def layout_cache_info() -> dict:
    """Hits, misses, size, resident bytes, the byte budget (``None`` when
    unbounded) and the evictions it made."""
    return {"hits": _layout_cache_hits, "misses": _layout_cache_misses,
            "size": len(_LAYOUT_CACHE),
            "resident_bytes": layout_cache_resident_bytes(),
            "max_bytes": _LAYOUT_CACHE_MAX_BYTES,
            "evictions": _layout_cache_evictions}


def layout_cache_clear() -> None:
    """Drop every cached layout and zero the counters (tests and
    memory-pressure hook)."""
    global _layout_cache_hits, _layout_cache_misses, _layout_cache_evictions
    _LAYOUT_CACHE.clear()
    _layout_cache_hits = 0
    _layout_cache_misses = 0
    _layout_cache_evictions = 0


# ---------------------------------------------------------------------------
# PartitionStore: byte-budgeted per-partition streamed layouts
# ---------------------------------------------------------------------------


def _ell_pack(keys: np.ndarray, slots: np.ndarray, wgt: np.ndarray, *,
              width: int, rows: int, num_vertices: int,
              pin: bool = False) -> dict:
    """Pack grouped COO into a ``rows``-row width-``width`` ELL.

    ``keys`` is sorted ascending (the group of each edge: its source for
    the push plane, its destination for pull); a group's edges fill
    ``ceil(count / width)`` consecutive rows in their order.  Returns
    CPU tensors ``{"key": (rows,) int32, "slot": (rows, width) int32,
    "wgt": (rows, width) float32}``, in pinned memory with ``pin``.  Pad
    rows' key is ``num_vertices`` (the fold kernel's pad owner) and pad
    slots hold ``PAD`` (the kernels' sentinel), weight 0; the JAX
    package pads both with ``num_vertices``.
    """
    out = {"key": torch.empty((rows,), dtype=torch.int32, pin_memory=pin),
           "slot": torch.empty((rows, width), dtype=torch.int32,
                               pin_memory=pin),
           "wgt": torch.empty((rows, width), dtype=torch.float32,
                              pin_memory=pin)}
    row_key, slot, w = (out[k].numpy() for k in ("key", "slot", "wgt"))
    row_key.fill(num_vertices)
    slot.fill(G.PAD)
    w.fill(0.0)
    keys = np.asarray(keys)
    n = len(keys)
    if n:
        starts = np.concatenate([[0], np.flatnonzero(keys[1:] != keys[:-1])
                                 + 1])
        counts = np.diff(np.append(starts, n))
        rows_per = -(-counts // width)
        row0 = np.zeros(len(starts), np.int64)
        np.cumsum(rows_per[:-1], out=row0[1:])
        used = int(rows_per.sum())
        if used > rows:
            raise ValueError(f"ELL needs {used} rows, given {rows}")
        within = np.arange(n, dtype=np.int64) - np.repeat(starts, counts)
        at = (np.repeat(row0, counts) + within // width) * width \
            + within % width
        row_key[:used] = np.repeat(keys[starts], rows_per)
        slot.reshape(-1)[at] = slots
        w.reshape(-1)[at] = wgt
    return out


class PartitionStore:
    """Byte-budgeted LRU of per-partition streamed ELL layouts.

    The streamed engine's host-side data plane, as in the JAX package:
    partitions are contiguous source-vertex intervals (``cuts``), each
    with two lazy layouts keyed ``(p, plane)``:

    * ``push``: forward ELL, rows grouped by source (``key`` = global
      source id, ``slot`` = destinations);
    * ``pull``: reversed ELL, rows grouped by destination (``key`` = the
      owner, ``slot`` = senders): the flat width-8 view and ``owner8``
      that the fused lane sweep takes.

    Every partition of a plane is padded to the plane's most rows, so one
    pair of device buffers takes any of them; ``rows_per_partition``
    keeps each one's real row count, which is all a kernel reads.  A
    layout builds from one partition's COO (a ``Graph`` slice or a
    container member) with one sort, and evicts least recently used past
    ``max_bytes``, never below two entries (the double buffer's floor).
    ``pin`` puts the entries in pinned memory, so their copies to the
    card are truly asynchronous.
    """

    def __init__(self, source, cuts, *, width: int = 8,
                 max_bytes: int | None = None, pin: bool = False):
        self.source = source
        self.cuts = np.asarray(cuts, np.int64)
        self.partitions = len(self.cuts) - 1
        self.width = int(width)
        self.max_bytes = max_bytes
        self.pin = bool(pin)
        self.num_vertices = int(source.num_vertices)
        deg = np.asarray(G._np(source.out_degrees), np.int64)
        cum = np.zeros(self.num_vertices + 1, np.int64)
        np.cumsum(deg, out=cum[1:])
        self.edges_per_partition = cum[self.cuts[1:]] - cum[self.cuts[:-1]]
        rows_v = -(-deg // self.width)
        rcum = np.zeros(self.num_vertices + 1, np.int64)
        np.cumsum(rows_v, out=rcum[1:])
        self.rows_per_partition = {
            "push": rcum[self.cuts[1:]] - rcum[self.cuts[:-1]],
            "pull": self._pull_rows()}
        self.push_rows_max = max(
            int(self.rows_per_partition["push"].max(initial=0)), 1)
        self.pull_rows_max = max(
            int(self.rows_per_partition["pull"].max(initial=0)), 1)
        self._entry_bytes = {
            plane: rows * (4 + 8 * self.width)
            for plane, rows in (("push", self.push_rows_max),
                                ("pull", self.pull_rows_max))}
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.builds = 0
        self.build_s = 0.0

    def _pull_rows(self) -> np.ndarray:
        """Exact per-partition pull row counts: a container's, built for
        this width, else a bincount of each partition's destinations."""
        pr = getattr(self.source, "pull_rows", None)
        if pr is not None and getattr(self.source, "width", None) \
                == self.width:
            return np.asarray(pr, np.int64)
        rows = np.zeros(self.partitions, np.int64)
        for p in range(self.partitions):
            _, dst, _ = self._coo(p)
            if len(dst):
                cnt = np.bincount(dst)
                rows[p] = int((-(-cnt // self.width)).sum())
        return rows

    def _coo(self, p: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if hasattr(self.source, "partition_coo"):
            return self.source.partition_coo(p)
        return G.partition_coo(self.source, int(self.cuts[p]),
                               int(self.cuts[p + 1]))

    def push_arrays(self, p: int) -> dict:
        """Partition ``p``'s forward (source-grouped) streamed ELL."""
        return self._get(p, "push")

    def pull_arrays(self, p: int) -> dict:
        """Partition ``p``'s reversed (destination-grouped) streamed ELL."""
        return self._get(p, "pull")

    def _get(self, p: int, plane: str) -> dict:
        key = (p, plane)
        hit = self._cache.get(key)
        if hit is not None:
            self._cache.move_to_end(key)
            self.hits += 1
            return hit
        self.misses += 1
        self.builds += 1
        t0 = time.perf_counter()
        src, dst, wgt = self._coo(p)
        keys, slots = (src, dst) if plane == "push" else (dst, src)
        keys = np.asarray(keys)
        if len(keys) > 1 and not bool(np.all(keys[1:] >= keys[:-1])):
            # one sort of (key, position) pairs: the stable order by key,
            # a group keeping its edges' order
            pairs = np.sort((keys.astype(np.int64) << 32)
                            | np.arange(len(keys), dtype=np.int64))
            order = pairs & 0xFFFFFFFF
            keys, slots, wgt = (pairs >> 32).astype(np.int32), \
                np.asarray(slots)[order], np.asarray(wgt)[order]
        rows = self.push_rows_max if plane == "push" else self.pull_rows_max
        entry = _ell_pack(keys, slots, wgt, width=self.width, rows=rows,
                          num_vertices=self.num_vertices, pin=self.pin)
        self.build_s += time.perf_counter() - t0
        self._cache[key] = entry
        self._evict(keep=key)
        return entry

    def evict_partition(self, p: int) -> int:
        """Drop both plane entries of partition ``p``; returns how many.
        The checksum-recovery hook: a poisoned entry must not survive the
        re-read."""
        dropped = 0
        for plane in ("push", "pull"):
            if self._cache.pop((p, plane), None) is not None:
                dropped += 1
                self.evictions += 1
        return dropped

    def _evict(self, keep: tuple) -> None:
        if self.max_bytes is None:
            return
        while (self.resident_bytes() > self.max_bytes
               and len(self._cache) > 2):
            victim = next((k for k in self._cache if k != keep), None)
            if victim is None:
                break
            del self._cache[victim]
            self.evictions += 1

    def resident_bytes(self) -> int:
        return sum(self._entry_bytes[plane] for _, plane in self._cache)

    def stats(self) -> dict:
        """Store observability, merged into the streamed run's stats (the
        JAX package's keys)."""
        return {"partitions": self.partitions,
                "width": self.width,
                "resident_bytes": self.resident_bytes(),
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "builds": self.builds,
                "build_s": self.build_s,
                "push_rows": self.push_rows_max,
                "pull_rows": self.pull_rows_max,
                "entry_bytes": dict(self._entry_bytes)}


# ---------------------------------------------------------------------------
# Dataset synthesis at the paper's SNAP sizes (offline stand-ins)
# ---------------------------------------------------------------------------

PAPER_GRAPHS = {
    # name: (|V|, |E|)  — Table V
    "email-Eu-core": (1_005, 25_571),
    "soc-Slashdot0922": (82_168, 948_464),
}


def load_paper_graph(name: str, seed: int = 0,
                     cache_dir: str | None = None) -> G.Graph:
    """R-MAT graph with the exact |V|/|E| of the paper's dataset."""
    v, e = PAPER_GRAPHS[name]
    if cache_dir:
        path = os.path.join(cache_dir, f"{name}.npz")
        if os.path.exists(path):
            src, dst = read_edge_list(path)
            return G.from_edge_list(src, dst, num_vertices=v)
    src, dst = G.rmat_edges(v, e, seed=seed)
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        write_edge_list(os.path.join(cache_dir, f"{name}.npz"), src, dst)
    return G.from_edge_list(src, dst, num_vertices=v)
