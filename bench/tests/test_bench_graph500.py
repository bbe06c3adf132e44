"""Graph500's counting on hand-made graphs: component labels, the tuples
a search is credited with (duplicates and self-loops included) and
degrees."""
from __future__ import annotations

import torch

from bench.harness import graph500 as g5
from bench.generators import kronecker as K

# two components {0, 1, 2} (a triangle, a duplicate tuple, a self-loop)
# and {3, 4}; vertex 5 has no tuple
U = torch.tensor([0, 1, 2, 0, 2, 3])
V = torch.tensor([1, 2, 0, 1, 2, 4])


def test_component_labels():
    lab = g5.component_labels(U, V, 6)
    assert lab[0] == lab[1] == lab[2]
    assert lab[3] == lab[4]
    assert len({int(lab[0]), int(lab[3]), int(lab[5])}) == 3


def test_labels_agree_with_a_union_find_on_a_random_graph():
    u, v = K.kronecker_tuples(8, 2, 0.57, 0.19, 0.19, K.generator(9, "cpu"))
    lab = g5.component_labels(u, v, 256)
    parent = list(range(256))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(u.tolist(), v.tolist()):
        parent[find(a)] = find(b)
    roots = [find(x) for x in range(256)]
    for x in range(256):
        for y in (0, 17, 101, 255):
            assert (roots[x] == roots[y]) == bool(lab[x] == lab[y])


def test_search_edges_count_every_tuple_of_the_component():
    lab = g5.component_labels(U, V, 6)
    per_vertex = g5.component_tuples(U, lab)[lab]
    assert per_vertex.tolist() == [5, 5, 5, 1, 1, 0]


def test_degrees_count_both_directions():
    # a tuple counts at both its ends; the self-loop (2, 2) counts at
    # neither, as the search keys are drawn
    assert g5.degrees(U, V, 6).tolist() == [3, 3, 2, 1, 1, 0]
    loop = torch.tensor([0, 1])
    assert g5.degrees(loop, loop, 2).tolist() == [0, 0]
