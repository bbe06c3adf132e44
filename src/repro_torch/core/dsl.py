"""The graph DSL (paper §IV): GAS vertex programs, in PyTorch.

A :class:`VertexProgram` is the paper's "think like a vertex" abstraction:
the user supplies *gather* (a message per in-edge), a *reduce*
accumulator, and *apply* (vertex update), plus frontier semantics.
Traversal order, layout, schedule and device placement are the
translator's job.  Gathers and applies are plain functions on torch
tensors; the templates below mirror ``repro.core.dsl`` one for one.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

GatherFn = Callable[[Any, Any, Any], Any]   # (src_value, edge_weight, src_degree) -> msg
ApplyFn = Callable[[Any, Any], Any]         # (old_value, reduced_msg) -> new_value


INIT_SPECS = ("iota",)               # named init specs (beyond scalars/arrays)


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """A GAS-model graph program (the DSL's function-layer object).

    ``init_value`` is a scalar or (V,) array, the named spec ``'iota'``
    (vertex id, e.g. WCC labels), or a callable ``fn(num_vertices) -> (V,)
    array``; the translator materializes it on the run's device.
    """

    name: str
    gather: GatherFn
    reduce: str                      # 'add' | 'min' | 'max'
    apply: ApplyFn
    init_value: Any                  # scalar | array | 'iota' | fn(V)->array
    frontier: str = "changed"        # 'changed' | 'all'
    value_dtype: torch.dtype = torch.float32
    # messages from inactive sources are masked to the reduce identity
    mask_inactive: bool = True
    max_iters: int | None = None     # None → |V| bound

    def __post_init__(self):
        if self.reduce not in ("add", "min", "max"):
            raise ValueError(f"unsupported reduce: {self.reduce}")
        if self.frontier not in ("changed", "all"):
            raise ValueError(f"unsupported frontier mode: {self.frontier}")
        if isinstance(self.init_value, str) and self.init_value not in INIT_SPECS:
            raise ValueError(f"unsupported init spec: {self.init_value!r}")

    def materialize_init(self, num_vertices: int,
                         device: torch.device | str = "cpu") -> torch.Tensor:
        """Initial (V,) vertex values for this program (paper: Vertices)."""
        dtype = self.value_dtype
        if isinstance(self.init_value, str):     # named spec
            if self.init_value == "iota":
                return torch.arange(num_vertices, dtype=dtype, device=device)
        if callable(self.init_value):
            return torch.as_tensor(np.asarray(self.init_value(num_vertices)),
                                   dtype=dtype).to(device)
        if np.isscalar(self.init_value) or np.ndim(self.init_value) == 0:
            return torch.full((num_vertices,), float(self.init_value)
                              if dtype.is_floating_point
                              else int(self.init_value),
                              dtype=dtype, device=device)
        return torch.as_tensor(np.asarray(self.init_value),
                               dtype=dtype).to(device)


def reduce_identity(op: str, dtype: torch.dtype) -> torch.Tensor:
    """The reduce's neutral element as a 0-d tensor of ``dtype``."""
    if dtype.is_floating_point:
        ident = {"add": 0.0, "min": float("inf"), "max": float("-inf")}[op]
    else:
        info = torch.iinfo(dtype)
        ident = {"add": 0, "min": info.max, "max": info.min}[op]
    return torch.tensor(ident, dtype=dtype)


# ---------------------------------------------------------------------------
# Algorithm-layer program templates.  Each factory is memoized on its
# arguments, so the translator's per-program caches hit for the natural
# repeat pattern ``translate(dsl.bfs_program(), g, ...)``.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def bfs_program(int_max: int = 2**30) -> VertexProgram:
    """BFS levels: msg = level[u] + 1, reduce min, apply min.

    ``int_max`` is the unreached sentinel.  It must leave headroom for the
    gather's ``+ 1`` in int32: ``2**31 - 1`` would wrap to ``-2**31`` on
    the first superstep and win every ``min`` thereafter, so out-of-range
    sentinels are rejected at construction.
    """
    if not 0 < int_max < 2**31 - 1:
        from ..errors import GraphValidationError
        raise GraphValidationError(
            f"bfs_program(int_max={int_max}): sentinel must lie in "
            f"(0, 2**31 - 1) so the gather's '+ 1' cannot wrap int32; "
            f"use the default 2**30")
    return VertexProgram(
        name="bfs",
        gather=lambda v, w, d: v + 1,
        reduce="min",
        apply=torch.minimum,
        init_value=int_max,
        frontier="changed",
        value_dtype=torch.int32,
    )


@functools.lru_cache(maxsize=None)
def sssp_program() -> VertexProgram:
    """SSSP (Bellman-Ford style): msg = dist[u] + w, reduce min, apply min."""
    return VertexProgram(
        name="sssp",
        gather=lambda v, w, d: v + w,
        reduce="min",
        apply=torch.minimum,
        init_value=float("inf"),
        frontier="changed",
        value_dtype=torch.float32,
    )


@functools.lru_cache(maxsize=None)
def pagerank_program(damping: float = 0.85, iters: int = 20) -> VertexProgram:
    """PageRank: msg = rank[u]/deg[u], reduce add, apply damped sum."""
    return VertexProgram(
        name="pagerank",
        gather=lambda v, w, d: v / torch.clamp_min(d, 1).to(v.dtype),
        reduce="add",
        apply=lambda old, s: (1.0 - damping) + damping * s,
        init_value=1.0,
        frontier="all",
        value_dtype=torch.float32,
        mask_inactive=False,
        max_iters=iters,
    )


@functools.lru_cache(maxsize=None)
def ppr_program(root: int = 0, damping: float = 0.85,
                iters: int = 20) -> VertexProgram:
    """Personalized PageRank from ``root``: damped sum with restart mass
    ``(1-d)`` on the personalization vertex (derived from the reduced
    vector's length, so the template stays graph-independent)."""
    def apply(old, s):
        e = (torch.arange(s.shape[0], device=s.device) == root).to(s.dtype)
        return (1.0 - damping) * e + damping * s

    return VertexProgram(
        name="ppr",
        gather=lambda v, w, d: v / torch.clamp_min(d, 1).to(v.dtype),
        reduce="add",
        apply=apply,
        init_value=0.0,
        frontier="all",
        value_dtype=torch.float32,
        mask_inactive=False,
        max_iters=iters,
    )


@functools.lru_cache(maxsize=None)
def wcc_program() -> VertexProgram:
    """Connected components by label propagation: reduce min of labels."""
    return VertexProgram(
        name="wcc",
        gather=lambda v, w, d: v,
        reduce="min",
        apply=torch.minimum,
        init_value="iota",           # label = own vertex id
        frontier="changed",
        value_dtype=torch.int32,
    )


@functools.lru_cache(maxsize=None)
def spmv_program() -> VertexProgram:
    """One y = A^T x step in GAS form: msg = x[u]*w, reduce add."""
    return VertexProgram(
        name="spmv",
        gather=lambda v, w, d: v * w,
        reduce="add",
        apply=lambda old, s: s,
        init_value=0.0,
        frontier="all",
        value_dtype=torch.float32,
        mask_inactive=False,
        max_iters=1,
    )


@functools.lru_cache(maxsize=None)
def degree_program() -> VertexProgram:
    """In-degree count: msg = 1 per edge, reduce add."""
    return VertexProgram(
        name="degree",
        gather=lambda v, w, d: torch.ones_like(v),
        reduce="add",
        apply=lambda old, s: s,
        init_value=0.0,
        frontier="all",
        value_dtype=torch.float32,
        mask_inactive=False,
        max_iters=1,
    )


# Name → zero-arg factory for every algorithm-layer template above.
PROGRAM_TEMPLATES: dict[str, Callable[[], VertexProgram]] = {
    "bfs": bfs_program,
    "sssp": sssp_program,
    "pagerank": pagerank_program,
    "ppr": ppr_program,
    "wcc": wcc_program,
    "spmv": spmv_program,
    "degree": degree_program,
}
