"""Algorithm layer: ``BFS(graph, ...)``-style one-call entry points.

Counterpart of ``repro.core.algorithms``.  Every algorithm is built from
the DSL and goes through translate → run, the paper's Algorithm 1 flow.
``device=None`` runs on the CUDA device and raises when there is none;
the tests pass ``device="cpu"``.  Results come back as tensors on the
run's device.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dsl
from .comm import CommManager
from .graph import Graph, from_edge_list, to_coo
from .scheduler import DirectionPolicy, ScheduleConfig
from .translator import translate

INT_MAX = 2**30


def _schedule(pipelines: int, pes: int, backend: str,
              direction: str | DirectionPolicy = "auto") -> ScheduleConfig:
    if isinstance(direction, str):
        direction = DirectionPolicy(mode=direction)
    return ScheduleConfig(pipelines=pipelines, pes=pes, backend=backend,
                          direction=direction)


def bfs(g: Graph, root: int = 0, *, pipelines: int = 8, pes: int = 1,
        backend: str = "auto", direction: str | DirectionPolicy = "auto",
        comm: CommManager | None = None, device=None):
    """Paper Algorithm 1. Returns ``(levels (V,), iterations, report)``;
    the levels are the same under 'pull', 'push' and 'auto'."""
    prog = translate(dsl.bfs_program(INT_MAX), g,
                     _schedule(pipelines, pes, backend, direction), comm,
                     device=device)
    levels, iters = prog.run(roots=root)
    return levels, iters, prog.report


def sssp(g: Graph, root: int = 0, *, pipelines: int = 8, pes: int = 1,
         backend: str = "auto", direction: str | DirectionPolicy = "auto",
         comm: CommManager | None = None, device=None):
    prog = translate(dsl.sssp_program(), g,
                     _schedule(pipelines, pes, backend, direction), comm,
                     device=device)
    dist, iters = prog.run(roots=root)
    return dist, iters, prog.report


def pagerank(g: Graph, *, iters: int = 20, damping: float = 0.85,
             pipelines: int = 8, pes: int = 1, backend: str = "auto",
             comm: CommManager | None = None, device=None):
    prog = translate(dsl.pagerank_program(damping, iters), g,
                     _schedule(pipelines, pes, backend), comm, device=device)
    ranks, n = prog.run()
    return ranks, n, prog.report


def wcc(g: Graph, *, pipelines: int = 8, pes: int = 1,
        backend: str = "auto", direction: str | DirectionPolicy = "auto",
        comm: CommManager | None = None, device=None):
    """Weakly connected components: label propagation on G ∪ Gᵀ."""
    src, dst, _ = to_coo(g)
    und = from_edge_list(np.concatenate([src, dst]),
                         np.concatenate([dst, src]),
                         num_vertices=g.num_vertices)
    prog = translate(dsl.wcc_program(), und,
                     _schedule(pipelines, pes, backend, direction), comm,
                     device=device)
    labels, iters = prog.run()
    return labels, iters, prog.report


def spmv(g: Graph, x, *, pipelines: int = 8, pes: int = 1,
         backend: str = "auto", comm: CommManager | None = None,
         device=None):
    """y[v] = Σ_{(u→v)} w(u,v)·x[u] — one GAS superstep."""
    prog = translate(dsl.spmv_program(), g,
                     _schedule(pipelines, pes, backend), comm, device=device)
    values, active = prog.init_state(values=x)
    y, _ = prog.superstep(values, active)
    return y, prog.report


def in_degrees(g: Graph, *, backend: str = "auto", device=None):
    """In-degree per vertex.  Its gather (``ones_like``) matches no menu
    module, so with the CUDA kernels on it plans the sparse backend, which
    is not ported yet (``ROADMAP.md`` §1 item 5.5)."""
    prog = translate(dsl.degree_program(), g, _schedule(8, 1, backend),
                     device=device)
    values, active = prog.init_state(
        values=torch.ones(g.num_vertices, dtype=torch.float32))
    deg, _ = prog.superstep(values, active)
    return deg


def traversed_edges(g: Graph, levels) -> int:
    """Edges traversed by a BFS (for MTEPS): out-edges of reached vertices."""
    lv = levels.cpu().numpy() if isinstance(levels, torch.Tensor) \
        else np.asarray(levels)
    deg = g.out_degrees.cpu().numpy()
    return int(deg[lv < INT_MAX].sum())
