"""Median milliseconds of one ``CompiledGraphProgram.run`` in the
window (the benchmark's span, ending in a synchronize)."""
from bench.harness.stats import percentile


def read(rec):
    return percentile([s["ms"] for s in rec.searches], 50)
