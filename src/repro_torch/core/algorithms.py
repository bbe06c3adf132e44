"""Algorithm layer: ``BFS(graph, ...)``-style one-call entry points.

Counterpart of ``repro.core.algorithms``.  Every algorithm is built from
the DSL and goes through translate → run, the paper's Algorithm 1 flow.
``device=None`` runs on the CUDA device and raises when there is none;
the tests pass ``device="cpu"``.  ``pes`` runs on a PE group:
``devices`` lists its devices (a device may repeat; by default every
visible card, or the one CPU, and fewer devices than ``pes`` degrade to
fewer PEs).  Results come back as tensors on the run's device.
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
              direction: str | DirectionPolicy = "auto",
              pull_sweep: str = "auto") -> ScheduleConfig:
    if isinstance(direction, str):
        direction = DirectionPolicy(mode=direction)
    return ScheduleConfig(pipelines=pipelines, pes=pes, backend=backend,
                          direction=direction, pull_sweep=pull_sweep)


def bfs(g: Graph, root: int = 0, *, pipelines: int = 8, pes: int = 1,
        backend: str = "auto", direction: str | DirectionPolicy = "auto",
        comm: CommManager | None = None, device=None,
        devices=None, pull_sweep: str = "auto"):
    """Paper Algorithm 1. Returns ``(levels (V,), iterations, report)``;
    the levels are the same under every direction and ``pull_sweep``
    (``'auto'``, ``'bitmap'`` or ``'dense'``)."""
    prog = translate(dsl.bfs_program(INT_MAX), g,
                     _schedule(pipelines, pes, backend, direction,
                               pull_sweep), comm, device=device,
                     devices=devices)
    levels, iters = prog.run(roots=root)
    return levels, iters, prog.report


def sssp(g: Graph, root: int = 0, *, pipelines: int = 8, pes: int = 1,
         backend: str = "auto", direction: str | DirectionPolicy = "auto",
         comm: CommManager | None = None, device=None,
         devices=None, pull_sweep: str = "auto"):
    prog = translate(dsl.sssp_program(), g,
                     _schedule(pipelines, pes, backend, direction,
                               pull_sweep), comm, device=device,
                     devices=devices)
    dist, iters = prog.run(roots=root)
    return dist, iters, prog.report


def pagerank(g: Graph, *, iters: int = 20, damping: float = 0.85,
             pipelines: int = 8, pes: int = 1, backend: str = "auto",
             comm: CommManager | None = None, device=None, devices=None):
    prog = translate(dsl.pagerank_program(damping, iters), g,
                     _schedule(pipelines, pes, backend), comm, device=device,
                     devices=devices)
    ranks, n = prog.run()
    return ranks, n, prog.report


def wcc(g: Graph, *, pipelines: int = 8, pes: int = 1,
        backend: str = "auto", direction: str | DirectionPolicy = "auto",
        comm: CommManager | None = None, device=None,
        devices=None, pull_sweep: str = "auto"):
    """Weakly connected components: label propagation on G ∪ Gᵀ."""
    src, dst, _ = to_coo(g)
    und = from_edge_list(np.concatenate([src, dst]),
                         np.concatenate([dst, src]),
                         num_vertices=g.num_vertices)
    prog = translate(dsl.wcc_program(), und,
                     _schedule(pipelines, pes, backend, direction,
                               pull_sweep), comm, device=device,
                     devices=devices)
    labels, iters = prog.run()
    return labels, iters, prog.report


def spmv(g: Graph, x, *, pipelines: int = 8, pes: int = 1,
         backend: str = "auto", comm: CommManager | None = None,
         device=None, devices=None):
    """y[v] = Σ_{(u→v)} w(u,v)·x[u] — one GAS superstep."""
    prog = translate(dsl.spmv_program(), g,
                     _schedule(pipelines, pes, backend), comm, device=device,
                     devices=devices)
    values, active = prog.init_state(values=x)
    y, _ = prog.superstep(values, active)
    return y, prog.report


def k_core(g: Graph, k: int, *, rounds: int | None = None,
           backend: str = "auto", device=None):
    """k-core decomposition by iterative peeling, in the DSL: activity in
    {0, 1} is the vertex value; each superstep counts active undirected
    neighbors (gather copy, reduce add) and the apply keeps a vertex alive
    iff it was alive with at least ``k`` of them.  The peel loop is a host
    loop that stops when a round changes nothing (one device→host read a
    round) or after ``rounds`` (default V) rounds.  Returns ``(membership
    (V,) bool numpy array, rounds run)``."""
    src, dst, _ = to_coo(g)
    und = from_edge_list(np.concatenate([src, dst]),
                         np.concatenate([dst, src]),
                         num_vertices=g.num_vertices)
    prog = dsl.VertexProgram(
        name="k_core",
        gather=lambda v, w, d: v,
        reduce="add",
        apply=lambda old, s: torch.where((old > 0) & (s >= k), 1.0, 0.0),
        init_value=1.0,
        frontier="all",
        value_dtype=torch.float32,
        mask_inactive=False,
        max_iters=rounds if rounds is not None else g.num_vertices,
    )
    compiled = translate(prog, und, _schedule(8, 1, backend), device=device)
    prev, active = compiled.init_state(
        values=torch.ones(g.num_vertices, dtype=torch.float32))
    vals, _ = compiled.superstep(prev, active)
    it = 1
    while it < compiled.max_iters and bool((vals != prev).any()):
        prev = vals
        vals, _ = compiled.superstep(vals, active)
        it += 1
    return (vals > 0).cpu().numpy(), it


def in_degrees(g: Graph, *, backend: str = "auto", device=None):
    """In-degree per vertex.  Its gather (``ones_like``) matches no menu
    module: with the CUDA kernels on it plans the sparse backend (only the
    plain path keeps it dense, through the one-gather-per-slot table)."""
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
