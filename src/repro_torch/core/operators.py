"""Atomic graph operators: the paper's Fig. 3 / Table IV inventory (25+).

Counterpart of ``repro.core.operators``, with the same three groups:

* **Graph data**: accessors and mutators over the CSR tensors.
* **Graph operation**: GAS-model message functions (Receive / Reduce /
  Apply / Send) plus frontier management.
* **Apply operator library**: the paper's "+ - * / % sqrt square" menu
  plus algorithm-aware templates.

Every operator is a plain function on tensors over the port's
:class:`~repro_torch.core.graph.Graph` (on whatever device the graph's
tensors are); graph mutators return a new ``Graph``.  Nothing on the
translator's path calls them: they are the paper's operator layer, and
``OPERATOR_REGISTRY`` at the bottom is its inventory, under the JAX
package's keys.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..kernels.ref import _SCATTER_REDUCE, _identity
from .graph import PAD, Graph

# ---------------------------------------------------------------------------
# Graph data: vertices
# ---------------------------------------------------------------------------


def get_vertex(g: Graph, v) -> torch.Tensor:
    """Paper: Get_vertex(i): vertex value by id."""
    return g.vertex_values[v]


def set_vertex_value(g: Graph, v, value) -> Graph:
    """Paper: Set_Vertex_value: functional update of one or many vertices."""
    values = g.vertex_values.clone()
    values[v] = value
    return dataclasses.replace(g, vertex_values=values)


def update_vertex(g: Graph, values: torch.Tensor,
                  mask: torch.Tensor | None = None) -> Graph:
    """Paper: Update_vertex: bulk vertex update (optionally masked)."""
    if mask is None:
        return dataclasses.replace(g, vertex_values=values)
    return dataclasses.replace(
        g, vertex_values=torch.where(mask, values, g.vertex_values))


def get_edge_offset(g: Graph, v) -> tuple[torch.Tensor, torch.Tensor]:
    """Paper: Get_edge_offset(v): CSR [start, end) of v's out-edges."""
    return g.edge_offsets[v], g.edge_offsets[torch.as_tensor(v) + 1]


def get_out_degree(g: Graph, v) -> torch.Tensor:
    return g.edge_offsets[torch.as_tensor(v) + 1] - g.edge_offsets[v]


def _edge_ids(g: Graph, v, max_degree: int):
    """``(ids, valid)``: v's out-edge ids padded to ``max_degree``."""
    start, end = get_edge_offset(g, v)
    ids = start + torch.arange(max_degree, dtype=torch.int32,
                               device=g.edge_offsets.device)
    return ids, ids < end


def get_out_edges_list(g: Graph, v: int, max_degree: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Paper: Get_out_edges_list: (edge ids, weights), PAD-padded to
    ``max_degree``."""
    ids, valid = _edge_ids(g, v, max_degree)
    ids = torch.where(valid, ids, PAD)
    w = torch.where(valid, g.edge_weights[ids.clamp(0, g.num_edges - 1)
                                          .long()], 0)
    return ids, w


def get_in_edges_list(g_rev: Graph, v: int, max_degree: int):
    """Paper: Get_in_edges_list: the same, on the transposed graph."""
    return get_out_edges_list(g_rev, v, max_degree)


def get_dest_v_list(g: Graph, v: int, max_degree: int) -> torch.Tensor:
    """Paper: Get_dest_V_list: out-neighbor ids of v (PAD-padded)."""
    ids, valid = _edge_ids(g, v, max_degree)
    nbr = g.edges_dst[ids.clamp(0, g.num_edges - 1).long()]
    return torch.where(valid, nbr, PAD)


def get_src_v_list(g_rev: Graph, v: int, max_degree: int) -> torch.Tensor:
    """Paper: Get_src_V_list: in-neighbor ids via the transposed graph."""
    return get_dest_v_list(g_rev, v, max_degree)


# ---------------------------------------------------------------------------
# Graph data: edges
# ---------------------------------------------------------------------------


def get_edge_src_id(g: Graph, e) -> torch.Tensor:
    """Paper: Get_src_V_id(e): source vertex of an edge id (CSR search)."""
    ends = g.edge_offsets[1:]
    e = torch.as_tensor(e, device=ends.device).to(ends.dtype)
    return torch.searchsorted(ends, e, right=True).to(torch.int32)


def get_edge_dst_id(g: Graph, e) -> torch.Tensor:
    """Paper: Get_dest_V_id(e)."""
    return g.edges_dst[e]


def get_edge_weight(g: Graph, e) -> torch.Tensor:
    """Paper: Get_edge_V_weight(e)."""
    return g.edge_weights[e]


def set_edge_weight(g: Graph, e, w) -> Graph:
    weights = g.edge_weights.clone()
    weights[e] = w
    return dataclasses.replace(g, edge_weights=weights)


# ---------------------------------------------------------------------------
# Graph operations (GAS): Receive / Reduce / Apply / Send
# ---------------------------------------------------------------------------


def receive(values: torch.Tensor, src_ids: torch.Tensor,
            pad_value=0) -> torch.Tensor:
    """Paper: Receive: gather neighbor data; PAD slots produce pad_value.

    values: (V,) vertex state; src_ids: any-shape int32 ids (may be PAD).
    """
    safe = src_ids.clamp(0, values.shape[0] - 1).long()
    out = values[safe]
    return torch.where(src_ids == PAD,
                       torch.tensor(pad_value, dtype=out.dtype,
                                    device=out.device), out)


def reduce_messages(messages: torch.Tensor, op: str = "add",
                    axis: int = -1) -> torch.Tensor:
    """Paper: Reduce: combine messages for a vertex with an accumulator."""
    if op == "add":
        return torch.sum(messages, dim=axis, dtype=messages.dtype)
    fn = {"min": torch.amin, "max": torch.amax, "or": torch.any}[op]
    return fn(messages, dim=axis)


def reduce_by_segment(messages: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int, op: str = "add") -> torch.Tensor:
    """Paper: Reduce across irregular destinations (scatter-reduce).

    An empty segment holds the reduce identity; ids outside ``[0,
    num_segments)`` are dropped, as ``jax.ops.segment_*`` drops them.
    """
    if op not in _SCATTER_REDUCE:
        raise ValueError(op)
    ids = segment_ids.long()
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = torch.full((num_segments + 1,), _identity(op, messages.dtype),
                     dtype=messages.dtype, device=messages.device)
    out.scatter_reduce_(0, ids.reshape(-1), messages.reshape(-1),
                        _SCATTER_REDUCE[op], include_self=True)
    return out[:num_segments]


def send(values: torch.Tensor, dst_ids: torch.Tensor, messages: torch.Tensor,
         op: str = "add") -> torch.Tensor:
    """Paper: Send: scatter updated messages to neighbors (PAD-safe)."""
    if op not in _SCATTER_REDUCE:
        raise ValueError(op)
    valid = dst_ids != PAD
    safe = torch.where(valid, dst_ids, 0).long().reshape(-1)
    msg = torch.where(valid, messages, _identity(op, messages.dtype))
    out = values.clone()
    if op == "add":
        return out.index_put_((safe,), msg.reshape(-1).to(values.dtype),
                              accumulate=True)
    return out.scatter_reduce_(0, safe, msg.reshape(-1).to(values.dtype),
                               _SCATTER_REDUCE[op], include_self=True)


# ---------------------------------------------------------------------------
# Frontier management (paper: frontiers "used like a queue", active vertices)
# ---------------------------------------------------------------------------


def make_frontier(num_vertices: int, roots) -> torch.Tensor:
    frontier = torch.zeros(num_vertices, dtype=torch.bool)
    frontier[torch.as_tensor(roots).long()] = True
    return frontier


def get_active_vertex(frontier: torch.Tensor) -> torch.Tensor:
    """Paper: Get_active_vertex: any work left?"""
    return torch.any(frontier)


def frontier_size(frontier: torch.Tensor) -> torch.Tensor:
    return torch.sum(frontier, dtype=torch.int32)


def advance_frontier(old: torch.Tensor,
                     updated_mask: torch.Tensor) -> torch.Tensor:
    """Next frontier = vertices whose value changed this superstep."""
    return updated_mask


# ---------------------------------------------------------------------------
# Apply operator library (paper: "+ - * / % sqrt square" + templates)
# ---------------------------------------------------------------------------

APPLY_OPS: dict[str, Callable] = {
    "add": lambda x, y: x + y,
    "sub": lambda x, y: x - y,
    "mul": lambda x, y: x * y,
    "div": lambda x, y: x / y,
    "mod": lambda x, y: x % y,
    "sqrt": lambda x, _=None: torch.sqrt(x),
    "square": lambda x, _=None: x * x,
    "plus_one": lambda x, _=None: x + 1,          # paper's BFS example
    "min": torch.minimum,
    "max": torch.maximum,
    "weighted_add": lambda x, w: x + w,            # SSSP relax template
    "damped_sum": lambda s, d=0.85: 0.15 + d * s,  # PageRank template
    "identity": lambda x, _=None: x,
}


def apply_op(name: str, *args):
    """Paper: Apply: pick an operator from the template menu."""
    return APPLY_OPS[name](*args)


# ---------------------------------------------------------------------------
# Inventory (paper Table IV: ours 25+), the JAX package's keys
# ---------------------------------------------------------------------------

OPERATOR_REGISTRY: dict[str, Callable] = {
    # graph data / vertices
    "Get_vertex": get_vertex,
    "Set_Vertex_value": set_vertex_value,
    "Update_vertex": update_vertex,
    "Get_edge_offset": get_edge_offset,
    "Get_out_degree": get_out_degree,
    "Get_out_edges_list": get_out_edges_list,
    "Get_in_edges_list": get_in_edges_list,
    "Get_dest_V_list": get_dest_v_list,
    "Get_src_V_list": get_src_v_list,
    # graph data / edges
    "Get_src_V_id": get_edge_src_id,
    "Get_dest_V_id": get_edge_dst_id,
    "Get_edge_V_weight": get_edge_weight,
    "Set_edge_weight": set_edge_weight,
    # GAS operations
    "Receive": receive,
    "Reduce": reduce_messages,
    "Reduce_segment": reduce_by_segment,
    "Send": send,
    # frontier
    "Make_frontier": make_frontier,
    "Get_active_vertex": get_active_vertex,
    "Frontier_size": frontier_size,
    "Advance_frontier": advance_frontier,
}
# apply templates are operators too (the paper counts its operator menu)
OPERATOR_REGISTRY.update({f"Apply_{k}": v for k, v in APPLY_OPS.items()})
