"""95th percentile of the latency of every query answered in the
window, from the client's send to the answer on the host."""
from bench.harness.stats import percentile


def read(rec):
    return percentile([q["ms"] for q in rec.queries], 95)
