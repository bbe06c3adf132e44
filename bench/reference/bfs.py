"""Level-synchronous BFS over a directed edge list, in plain PyTorch.

The same computation as the port's frozen ``numpy_bfs`` (levels from
the root, ``unreached`` where no path leads), on an edge list in place
of a CSR, so it runs on the card as well as on the host.

As a kind of query (``bench/harness/check.py``): ``bfs_mismatch``
counts the vertices whose level differs from the reference's (levels
are exact); the control leaves the last level out, since int32 levels
have no lower precision.
"""
from __future__ import annotations

import torch

# a vertex no path reaches (the level ``dsl.bfs_program`` gives it by
# default)
UNREACHED = 2 ** 30
NUMBER = "bfs_mismatch"
SAMPLE = 16                 # answers a run keeps for the check


def combine(a: int, b: int) -> int:
    return a + b


def answer(ref, root: int) -> torch.Tensor:
    """The reference's levels from ``root``."""
    return ref.memo(("bfs", root), lambda: bfs_levels(
        ref.src, ref.dst, ref.n, root, UNREACHED))


def reading(ref, a) -> int:
    got = torch.as_tensor(a.value).to(ref.src.device, torch.int32)
    return int((got != answer(ref, a.root)).sum())


def control(ref, a) -> torch.Tensor:
    """The reference one level short of the end."""
    full = answer(ref, a.root)
    return bfs_levels(ref.src, ref.dst, ref.n, a.root, UNREACHED,
                      max_levels=max(depth(full, UNREACHED) - 1, 0))


def bfs_levels(src: torch.Tensor, dst: torch.Tensor, n: int, root: int,
               unreached: int, max_levels: int | None = None
               ) -> torch.Tensor:
    """int32 levels from ``root``; ``max_levels`` stops after that many
    levels (``None``: until the frontier empties)."""
    level = torch.full((n,), unreached, dtype=torch.int32,
                       device=src.device)
    level[root] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=src.device)
    frontier[root] = True
    depth = 0
    while max_levels is None or depth < max_levels:
        reach = dst[frontier[src]]
        nxt = torch.zeros(n, dtype=torch.bool, device=src.device)
        nxt[reach] = True
        nxt &= level == unreached
        if not bool(nxt.any()):
            break
        depth += 1
        level[nxt] = depth
        frontier = nxt
    return level


def depth(level: torch.Tensor, unreached: int) -> int:
    """The deepest level reached."""
    return int(level[level != unreached].max())
