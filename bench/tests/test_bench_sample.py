"""The check's sample: a uniform reservoir of each kind's answers over
the whole window, each kind's longest answer beside it, and an answer
built only when it is kept."""
from __future__ import annotations

import numpy as np

from bench.harness.check import Answer, Sample


def _offer_all(sample, n, kind="bfs", lengths=None):
    built = []

    def make(i):
        def build():
            built.append(i)
            return Answer(kind, i, None)
        return build

    for i in range(n):
        sample.offer(kind, make(i),
                     None if lengths is None else lengths[i])
    return built


def test_the_reservoir_is_uniform_over_the_whole_window():
    n, cap, kept = 2000, 8, []
    for seed in range(300):
        s = Sample(lambda kind: cap, 2 ** 31 + seed)
        _offer_all(s, n)
        roots = [a.root for a in s.answers()]
        assert len(roots) == len(set(roots)) == cap
        kept += roots
    kept = np.asarray(kept)
    # every quarter of the window holds a quarter of the kept answers
    share = np.bincount(kept * 4 // n, minlength=4) / kept.size
    assert np.all(np.abs(share - 0.25) < 0.02), share
    assert abs(kept.mean() / n - 0.5) < 0.02


def test_each_kind_has_its_own_reservoir():
    s = Sample({"bfs": 3, "ppr": 1}.get, 7)
    _offer_all(s, 50, "bfs")
    _offer_all(s, 50, "ppr")
    kinds = [a.kind for a in s.answers()]
    assert kinds.count("bfs") == 3 and kinds.count("ppr") == 1


def test_the_longest_answer_is_kept_beside_the_sample_once():
    s = Sample(lambda kind: 2, 11)
    lengths = [1] * 100
    lengths[61] = 9
    _offer_all(s, 100, lengths=lengths)
    roots = [a.root for a in s.answers()]
    assert 61 in roots and len(roots) == len(set(roots))
    assert len(roots) in (2, 3)


def test_an_answer_is_built_only_when_kept():
    s = Sample(lambda kind: 4, 3)
    built = _offer_all(s, 1000)
    assert 4 <= len(built) < 100
    assert {a.root for a in s.answers()} <= set(built)


def test_the_same_seed_keeps_the_same_answers():
    def roots(seed):
        s = Sample(lambda kind: 5, seed)
        _offer_all(s, 500)
        return [a.root for a in s.answers()]
    assert roots(2 ** 33 + 1) == roots(2 ** 33 + 1)
    assert roots(2 ** 33 + 1) != roots(2 ** 33 + 2)
