"""Graph500's counting, in plain PyTorch: component labels, the tuples a
search is credited with, and degrees.

The specification credits a search with "the number of input edge
tuples within the component traversed by the search, counting any
multiple edges and self-loops" (v3.0, section 9.2).  That count comes
from the benchmark's own component labels, made once from the tuples,
never from the program's counters.
"""
from __future__ import annotations

import torch


def component_labels(u: torch.Tensor, v: torch.Tensor, n: int
                     ) -> torch.Tensor:
    """A label a vertex, equal within a connected component of the
    undirected tuples ``(u, v)`` and distinct between components.

    Hooking and shortcutting: each label names a vertex of its own
    component, so lowering it to a neighbour's label or to its label's
    label keeps that, and at the fixed point every tuple's ends agree.
    """
    label = torch.arange(n, dtype=torch.int64, device=u.device)
    while True:
        lu, lv = label[u], label[v]
        low = torch.minimum(lu, lv)
        new = label.clone()
        for idx in (lu, lv, u, v):
            new.scatter_reduce_(0, idx, low, "amin")
        while True:
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, label):
            return label
        label = new


def component_tuples(u: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Input tuples a component, indexed by the component's label (both
    ends of a tuple share it)."""
    return torch.bincount(label[u], minlength=label.numel())


def degrees(u: torch.Tensor, v: torch.Tensor, n: int) -> torch.Tensor:
    """Each vertex's degree not counting self-loops, as the search keys
    are drawn (v3.0: keys "with degree at least one, not
    counting self-loops"): a tuple ``u != v`` counts once at each end."""
    other = u != v
    return (torch.bincount(u[other], minlength=n)
            + torch.bincount(v[other], minlength=n))
