"""Single-source shortest paths by Bellman-Ford over a directed edge
list, in plain PyTorch.

Each relaxation computes ``dist[u] + w`` in ``dtype`` and keeps the
least; it stops when no distance falls.  Adding a non-negative weight
never lowers a distance and is monotone, so the fixed point is the least
rounded path sum whatever the order of relaxations: float32 here gives
the value every exact float32 shortest-path engine gives, bit for bit.

As a kind of query (``bench/harness/check.py``): ``sssp_mismatch``
counts the vertices whose float32 distance differs bit for bit (``inf``
equal to ``inf``); the control is the reference in bfloat16.
"""
from __future__ import annotations

import torch

NUMBER = "sssp_mismatch"
SAMPLE = 6                  # answers a run keeps for the check


def combine(a: int, b: int) -> int:
    return a + b


def answer(ref, root: int, dtype=torch.float32) -> torch.Tensor:
    """The reference's distances from ``root``, computed in ``dtype``,
    as float32."""
    return ref.memo(("sssp", root, dtype), lambda: sssp(
        ref.src, ref.dst, ref.wgt, ref.n, root, dtype).float())


def reading(ref, a) -> int:
    got = torch.as_tensor(a.value).to(ref.src.device, torch.float32)
    return int((got != answer(ref, a.root)).sum())


def control(ref, a) -> torch.Tensor:
    return answer(ref, a.root, torch.bfloat16)


def sssp(src: torch.Tensor, dst: torch.Tensor, wgt: torch.Tensor, n: int,
         root: int, dtype=torch.float32) -> torch.Tensor:
    """Distances from ``root`` in ``dtype`` (``inf`` where unreached)."""
    w = wgt.to(dtype)
    dist = torch.full((n,), float("inf"), dtype=dtype, device=src.device)
    dist[root] = 0
    active = torch.zeros(n, dtype=torch.bool, device=src.device)
    active[root] = True
    while bool(active.any()):
        live = active[src]
        s, d = src[live], dst[live]
        cand = dist[s] + w[live]
        new = dist.clone()
        new.scatter_reduce_(0, d, cand, "amin")
        active = new < dist
        dist = new
    return dist
