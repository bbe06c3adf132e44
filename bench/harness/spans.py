"""Spans the benchmark records around its calls into each layer.

A span is ``(name, start, end)`` in host seconds (``perf_counter``),
kept in memory.  While a trace is on, each span is also a profiler range
named ``bench.<name>``, so the trace can say what the host was doing in
a gap of the device.
"""
from __future__ import annotations

import contextlib
import time


class Spans:
    def __init__(self):
        self.items: list[tuple[str, float, float]] = []
        self.traced = False

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.traced:
            from torch.profiler import record_function
            with record_function("bench." + name):
                yield
        else:
            yield
        self.items.append((name, t0, time.perf_counter()))

    def total(self, name: str) -> float | None:
        """Summed seconds of the spans called ``name``; ``None`` if none."""
        d = [b - a for n, a, b in self.items if n == name]
        return sum(d) if d else None
