"""The Graph500 Kronecker generator: counts, determinism, the label
permutation, and the initiator's probabilities."""
from __future__ import annotations

import torch

from bench.generators import kronecker as K


def _tuples(seed, scale=10, ef=16):
    return K.kronecker_tuples(scale, ef, 0.57, 0.19, 0.19,
                              K.generator(seed, "cpu"))


def test_counts_and_range():
    u, v = _tuples(7)
    assert u.numel() == v.numel() == 16 << 10
    assert u.dtype == v.dtype == torch.int64
    assert int(u.min()) >= 0 and int(u.max()) < 1 << 10
    assert int(v.min()) >= 0 and int(v.max()) < 1 << 10


def test_same_seed_same_tuples_other_seed_other():
    u1, v1 = _tuples(2 ** 31 + 11)
    u2, v2 = _tuples(2 ** 31 + 11)
    u3, _ = _tuples(2 ** 31 + 12)
    assert torch.equal(u1, u2) and torch.equal(v1, v2)
    assert not torch.equal(u1, u3)


def test_large_seeds_accepted():
    K.generator(2 ** 33 + 5, "cpu")
    K.generator(-3, "cpu")


def test_permutation_is_a_bijection_that_keeps_degrees():
    gen = K.generator(5, "cpu")
    u0, v0 = K.kronecker_bits(9, 8, 0.57, 0.19, 0.19, gen)
    u, v, perm = K.permute(u0, v0, 1 << 9, gen)
    assert torch.equal(torch.sort(perm).values, torch.arange(1 << 9))
    deg0 = torch.bincount(torch.cat([u0, v0]), minlength=1 << 9)
    deg = torch.bincount(torch.cat([u, v]), minlength=1 << 9)
    assert torch.equal(deg[perm], deg0)
    assert torch.equal(torch.sort(deg).values, torch.sort(deg0).values)
    # the same tuples, shuffled: the multisets of (u, v) pairs agree
    key0 = torch.sort(perm[u0] * (1 << 9) + perm[v0]).values
    assert torch.equal(torch.sort(u * (1 << 9) + v).values, key0)


def test_initiator_probabilities():
    gen = K.generator(1, "cpu")
    u, v = K.kronecker_bits(1, 1 << 16, 0.57, 0.19, 0.19, gen)
    n = u.numel()
    share = {q: float(((u == q[0]) & (v == q[1])).sum()) / n
             for q in ((0, 0), (0, 1), (1, 0), (1, 1))}
    for q, want in {(0, 0): 0.57, (0, 1): 0.19, (1, 0): 0.19,
                    (1, 1): 0.05}.items():
        assert abs(share[q] - want) < 0.01, (q, share[q])


def test_weights_uniform_float32():
    w = K.uniform_weights(1 << 14, K.generator(3, "cpu"))
    assert w.dtype == torch.float32
    assert float(w.min()) >= 0.0 and float(w.max()) < 1.0
    assert abs(float(w.mean()) - 0.5) < 0.02
