"""The comparison that decides ``correct``, and its control.

A driver offers every answer of the window to a :class:`Sample`, which
keeps a uniform sample of each kind of query (a reservoir as large as
the kind's ``SAMPLE``) and the kind's longest answer.  After the
program has been released, each kept answer is held against the plain
reference of its kind, ``bench/reference/<kind>.py``, computed from the
benchmark's own edge list on the same device.  A kind's module gives:

- ``NUMBER``: the name of the number compared (``bfs_mismatch``,
  ``sssp_mismatch``, ``dist_mismatch``, ``ppr_gap``, ...);
- ``SAMPLE``: how many answers of the kind a run keeps;
- ``combine(a, b)``: how readings of two answers make one number (a sum
  of mismatches, the largest gap);
- ``reading(ref, answer)``: the answer's reading against the reference
  (``ref`` is a :class:`References`);
- ``control(ref, answer)``: the control's answer to the same query, the
  reference one step of precision lower, or with its guarantee broken
  where the answer has no lower precision.

Beside them, ``unanswered`` counts the queries or searches of the window
with no exact answer a grace period past the window's close.  Each
number is judged against the limit the configuration states.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Answer:
    kind: str                 # a module of bench/reference
    root: int
    value: object             # the program's answer, as it gave it
    target: int | None = None


class Sample:
    """A uniform sample of a window's answers, a reservoir for each kind
    of query, and each kind's longest answer beside it."""

    def __init__(self, size, seed: int):
        self.size = size                      # kind -> answers to keep
        self.rng = np.random.default_rng([int(seed) % (1 << 64), 1])
        self.kept: dict = {}
        self.seen: dict = {}
        self.longest: dict = {}

    def offer(self, kind: str, make, length: int | None = None) -> None:
        """Offer the next answer of ``kind``; ``make()`` builds its
        :class:`Answer`, and is called only if the answer is kept.
        ``length`` (supersteps or iterations) picks the longest."""
        n = self.seen.get(kind, 0)
        self.seen[kind] = n + 1
        cap = int(self.size(kind))
        box = self.kept.setdefault(kind, [])
        j = n if n < cap else int(self.rng.integers(n + 1))
        a = None
        if j < cap:
            a = make()
            if j < len(box):
                box[j] = a
            else:
                box.append(a)
        if length is not None and length > self.longest.get(
                kind, (-1, None))[0]:
            self.longest[kind] = (length, a if a is not None else make())

    def answers(self) -> list[Answer]:
        out = [a for box in self.kept.values() for a in box]
        kept = {id(a) for a in out}
        return out + [a for _, a in self.longest.values()
                      if id(a) not in kept]


class References:
    """What the references read: the benchmark's directed edge list on
    the device, the vertex count, the server's parameters, the kinds of
    query by name; and each reference answer, computed once."""

    def __init__(self, edges, n: int, params: dict | None, kind):
        self.src, self.dst, self.wgt = edges
        self.n = n
        self.params = params or {}
        self.kind = kind                      # name -> bench/reference module
        self._memo: dict = {}

    def memo(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]


def readings(answers: list[Answer], refs: References) -> list:
    """``(kind module, reading)`` of each answer."""
    out = []
    for a in answers:
        kind = refs.kind(a.kind)
        out.append((kind, kind.reading(refs, a)))
    return out


def numbers(read: list) -> dict:
    """The numbers (``unanswered`` aside) from per-answer readings, each
    kind's combined by its ``combine``; a kind with no sampled answer
    gives no number."""
    out: dict = {}
    for kind, value in read:
        name = kind.NUMBER
        out[name] = value if name not in out else kind.combine(
            out[name], value)
    return out


def control(answers: list[Answer], refs: References) -> dict:
    """The numbers of the control put in the program's place."""
    return numbers(readings(
        [dataclasses.replace(a, value=refs.kind(a.kind).control(refs, a))
         for a in answers], refs))


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: correct when every
    number is at most its limit.  A number with no limit fails."""
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in found.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
