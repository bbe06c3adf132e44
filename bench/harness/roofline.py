"""The least bytes a search must move, whatever implements it.

A level-synchronous BFS from a root reads each directed edge out of a
reached vertex once (its 4-byte target id) and, for every vertex, its
4-byte CSR offset and its 4-byte level written once.  On an undirected
input given in both directions a component of ``t`` tuples has ``2 t``
directed edges, all out of reached vertices.  The count is bandwidth
bound: a search does no arithmetic worth counting against the card's
operations per second.
"""
from __future__ import annotations

EDGE_BYTES = 4
VERTEX_BYTES = 8


def bfs_search_bytes(component_tuples: int, num_vertices: int) -> int:
    """Bytes a search from a root whose component holds
    ``component_tuples`` input tuples must move."""
    return (EDGE_BYTES * 2 * int(component_tuples)
            + VERTEX_BYTES * int(num_vertices))
