"""Spans inside the port's host loops, on the profiler's clock.

The run loop, the lane loop and the graph server mark their stretches of
host work with :func:`span`::

    with tracing.span("run.read"):
        m_f, n_f, r_f, done = self._occupancy(active, pending)

A span records only while a ``torch.profiler`` session records.  Else
:func:`span` returns one shared no-op context after a single flag test:
nothing is allocated and no clock is read.  A span records
``(name, t0, t1, parent)``: ``t0`` and ``t1`` on ``time.perf_counter``,
the clock of the benchmark's own spans, and ``parent`` the span open
around it (the host loops are single-threaded, so a plain stack of open
spans is enough).  The newest :data:`CAPACITY` spans stay in memory and
are written nowhere.  The span is also a range named
``repro_torch.<name>`` in the profiler's host events, so its trace
carries the span beside the device's kernels.  The range is the
profiler's fast form of ``record_function``: about 2 us a range against
14 us on an H100 host, and no mirror among the device's events.

:func:`records`, :func:`count` and :func:`self_seconds` read the spans
of a stretch of host time.  A span's self time is its duration less the
part of it its child spans cover.
"""
from __future__ import annotations

import collections
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["CAPACITY", "PREFIX", "Span", "count", "records", "self_seconds",
           "span"]

# spans kept, the newest: a traced 3 s stretch of either benchmark cell
# records under 6,000
CAPACITY = 2 ** 16
PREFIX = "repro_torch."     # the profiler range's name is PREFIX + name

_open: list = []                    # the spans open now, innermost last
_kept: collections.deque = collections.deque(maxlen=CAPACITY)


class _Off:
    """The context a span is while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One recorded stretch of host time: ``name``, ``t0`` and ``t1``
    (``perf_counter`` seconds) and ``parent``, the span open around it
    (``None`` at the top)."""
    __slots__ = ("name", "t0", "t1", "parent", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.parent = _open[-1] if _open else None
        self._range = torch._C._profiler._RecordFunctionFast(
            PREFIX + self.name)
        self._range.__enter__()
        _open.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        _open.pop()
        self._range.__exit__(*exc)
        self._range = None
        _kept.append(self)
        return False


def span(name: str):
    """A context that records the stretch it encloses as ``name`` while a
    ``torch.profiler`` session records, and does nothing else."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name)


def _names(names) -> frozenset:
    return frozenset((names,) if isinstance(names, str) else names)


def records(lo: float = float("-inf"),
            hi: float = float("inf")) -> list[Span]:
    """The kept spans that lie wholly inside ``[lo, hi]``
    (``perf_counter`` seconds), in the order they closed."""
    return [s for s in _kept if lo <= s.t0 and s.t1 <= hi]


def count(names, lo: float = float("-inf"), hi: float = float("inf")) -> int:
    """How many kept spans named ``names`` (a name or several) lie inside
    ``[lo, hi]``."""
    want = _names(names)
    return sum(s.name in want for s in records(lo, hi))


def self_seconds(names, lo: float = float("-inf"),
                 hi: float = float("inf")) -> float:
    """Summed self time, in seconds, of the kept spans named ``names`` that
    lie inside ``[lo, hi]``: each span's duration less the durations of
    its child spans."""
    want = _names(names)
    inside = records(lo, hi)
    total = 0.0
    chosen = set()
    for s in inside:
        if s.name in want:
            total += s.t1 - s.t0
            chosen.add(id(s))
    for s in inside:
        if s.parent is not None and id(s.parent) in chosen:
            total -= s.t1 - s.t0
    return total
