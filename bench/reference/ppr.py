"""Personalized PageRank by power iteration over a directed edge list,
in plain PyTorch.

The port's documented semantics (``dsl.ppr_program``): every vertex
starts at 0; each of ``iters`` steps sends ``x[u] / max(outdeg(u), 1)``
along every edge ``u -> v`` (a duplicate edge sends twice), sums what
arrives, and sets ``x = (1 - damping) * e_root + damping * sum``.

As a kind of query (``bench/harness/check.py``): ``ppr_gap`` is the
largest gap to the float64 reference as a share of the reference's
largest entry, the worst over the sampled answers; ``damping`` and
``iters`` are the configuration's ``ppr_damping`` and ``ppr_iters``; the
control is the reference in bfloat16.
"""
from __future__ import annotations

import torch

NUMBER = "ppr_gap"
SAMPLE = 3                  # answers a run keeps for the check
combine = max


def answer(ref, root: int, dtype=torch.float64) -> torch.Tensor:
    """The reference's vector from ``root``, computed in ``dtype``, as
    float64."""
    return ref.memo(("ppr", root, dtype), lambda: ppr(
        ref.src, ref.dst, ref.n, root, ref.params["ppr_damping"],
        ref.params["ppr_iters"], dtype).double())


def reading(ref, a) -> float:
    want = answer(ref, a.root)
    got = torch.as_tensor(a.value).to(ref.src.device, torch.float64)
    return float((got - want).abs().max() / want.abs().max())


def control(ref, a) -> torch.Tensor:
    return answer(ref, a.root, torch.bfloat16)


def ppr(src: torch.Tensor, dst: torch.Tensor, n: int, root: int,
        damping: float, iters: int, dtype=torch.float64) -> torch.Tensor:
    """The ``iters``-step vector from ``root``, computed in ``dtype``."""
    deg = torch.bincount(src, minlength=n).clamp_min(1).to(dtype)
    x = torch.zeros(n, dtype=dtype, device=src.device)
    for _ in range(iters):
        msg = x[src] / deg[src]
        s = torch.zeros(n, dtype=dtype, device=src.device)
        s.index_add_(0, dst, msg)
        x = damping * s
        x[root] += 1.0 - damping
    return x
