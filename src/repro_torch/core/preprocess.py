"""Preprocessing library (paper §IV-C): FIFO and Layout, host-side.

Counterpart of ``repro.core.preprocess`` for the resident single-device
path: edge-list I/O, the paper-sized synthetic graphs, and the
graph-keyed cache of derived layouts that ``translate`` reads.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time

import numpy as np

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

    def on(self, layout, device):
        """``layout`` (a product of this cache) with its tensors on
        ``device``, copied once per device."""
        key = (id(layout), str(device))
        if key not in self._on_device:
            self._on_device[key] = (layout, G.to_device(layout, device))
        return self._on_device[key][1]


_LAYOUT_CACHE: collections.OrderedDict = collections.OrderedDict()
_LAYOUT_CACHE_MAX = 8


def _layout_key(g: G.Graph) -> tuple:
    return (id(g.edge_offsets), id(g.edges_dst), id(g.edge_weights),
            g.num_vertices, g.num_edges)


def layouts_for(g: G.Graph) -> GraphLayouts:
    """Memoized :class:`GraphLayouts` for ``g``, keyed on the identity of
    its structure tensors; an entry holds those tensors, so an id cannot
    be recycled while the entry lives."""
    key = _layout_key(g)
    hit = _LAYOUT_CACHE.get(key)
    if hit is not None and hit.graph.edges_dst is g.edges_dst \
            and hit.graph.edge_offsets is g.edge_offsets \
            and hit.graph.edge_weights is g.edge_weights:
        _LAYOUT_CACHE.move_to_end(key)
        return hit
    entry = GraphLayouts(graph=g)
    _LAYOUT_CACHE[key] = entry
    while len(_LAYOUT_CACHE) > _LAYOUT_CACHE_MAX:
        _LAYOUT_CACHE.popitem(last=False)
    return entry


def layout_cache_clear() -> None:
    """Drop every cached layout (tests and memory-pressure hook)."""
    _LAYOUT_CACHE.clear()


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
