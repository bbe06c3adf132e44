"""The Graph500 Kronecker edge generator, on the device, from a seed.

A copy of the specification's generator (Graph500 v3.0, section 3.2,
``kronecker_generator.m``): ``edgefactor * 2**scale`` undirected tuples,
each built bit by bit from the initiator probabilities A, B, C (D the
rest); the vertex labels then permuted at random and the tuples shuffled.
Every draw comes from one ``torch.Generator`` on the device, in a few
large calls, so the same seed gives the same tuples on the same device.

A configuration names this generator with ``"generator": "kronecker"``
and gives ``scale``, ``edgefactor``, ``a``, ``b``, ``c`` and ``weights``
(``null``, or ``"uniform01"`` for kernel 3's weights); the harness calls
:func:`make`.
"""
from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` (any integer up to
    2**64 - 1)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def kronecker_bits(scale: int, edgefactor: int, a: float, b: float,
                   c: float, gen: torch.Generator
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``edgefactor * 2**scale`` tuples before the permutations:
    bit ``k`` of both ends drawn together, ``(0, 0)`` with probability A,
    ``(0, 1)`` B, ``(1, 0)`` C and ``(1, 1)`` the rest (int64)."""
    m = edgefactor << scale
    device = gen.device
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    u = torch.zeros(m, dtype=torch.int64, device=device)
    v = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        ii = torch.rand(m, generator=gen, device=device) > ab
        thresh = torch.where(ii, c_norm, a_norm)
        jj = torch.rand(m, generator=gen, device=device) > thresh
        u += ii.to(torch.int64) << bit
        v += jj.to(torch.int64) << bit
    return u, v


def permute(u: torch.Tensor, v: torch.Tensor, n: int, gen: torch.Generator
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(u, v, perm)``: the labels mapped through a random permutation
    ``perm`` of ``n`` vertices, then the tuples shuffled."""
    perm = torch.randperm(n, generator=gen, device=gen.device)
    u, v = perm[u], perm[v]
    order = torch.randperm(u.numel(), generator=gen, device=gen.device)
    return u[order], v[order], perm


def kronecker_tuples(scale: int, edgefactor: int, a: float, b: float,
                     c: float, gen: torch.Generator
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(u, v)``: the ``edgefactor * 2**scale`` undirected tuples, int64
    on the generator's device, labels permuted and tuples shuffled."""
    u, v = kronecker_bits(scale, edgefactor, a, b, c, gen)
    u, v, _ = permute(u, v, 1 << scale, gen)
    return u, v


def uniform_weights(m: int, gen: torch.Generator) -> torch.Tensor:
    """Graph500 kernel 3's edge weights: U[0, 1) float32, one a tuple."""
    return torch.rand(m, generator=gen, device=gen.device,
                      dtype=torch.float32)


def make(config: dict, seed: int, device
         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """``(u, v, w)``: the configuration's tuples from ``seed`` on
    ``device``, and their weights (``None`` for an unweighted graph)."""
    gen = generator(seed, device)
    u, v = kronecker_tuples(int(config["scale"]), int(config["edgefactor"]),
                            config["a"], config["b"], config["c"], gen)
    weights = config.get("weights")
    if weights is None:
        return u, v, None
    if weights != "uniform01":
        raise ValueError(f"unknown weights {weights!r}")
    return u, v, uniform_weights(u.numel(), gen)
