"""The program's own spans (``repro_torch.core.tracing``) in a run's
traced stretch.

The port records its spans while the profiler does, on the host clock
of the benchmark's spans, so the traced stretch is
``[rec.trace.start, rec.trace.end]``.  A program without the tracer, or
a run without a trace, has none to read: every function here then
returns ``None``.
"""
from __future__ import annotations


def _tracer(rec):
    """``(tracing module, (start, end))``, or ``(None, None)``."""
    if rec.trace is None:
        return None, None
    try:
        from repro_torch.core import tracing
    except ImportError:
        return None, None
    return tracing, (rec.trace.start, rec.trace.end)


def count(rec, names) -> int | None:
    """Spans named ``names`` in the traced stretch."""
    tracing, stretch = _tracer(rec)
    return None if tracing is None else tracing.count(names, *stretch)


def self_ms(rec, names) -> float | None:
    """Summed self milliseconds of the spans named ``names`` in the traced
    stretch; ``None`` if there is none."""
    tracing, stretch = _tracer(rec)
    if tracing is None or not tracing.count(names, *stretch):
        return None
    return 1e3 * tracing.self_seconds(names, *stretch)


def ms_each(rec, names) -> float | None:
    """Mean self milliseconds of a span named ``names`` in the traced
    stretch."""
    ms = self_ms(rec, names)
    return None if ms is None else ms / count(rec, names)


def ms_per_engine_query(rec, names) -> float | None:
    """Self milliseconds of the spans named ``names`` in the traced
    stretch, per query the engine answered there (landmark answers
    aside)."""
    ms = self_ms(rec, names)
    if ms is None:
        return None
    lo, hi = rec.trace.start, rec.trace.end
    n = sum(q["served_by"] != "landmark" and lo <= q["at"] <= hi
            for q in rec.queries)
    return ms / n if n else None
