"""Host milliseconds a superstep of a search spends enqueueing its work
(self time of the program's ``run.pull`` and ``run.push`` spans), per
superstep of the traced stretch."""
from bench.harness import program_spans

STEPS = ("run.pull", "run.push")


def read(rec):
    steps = program_spans.count(rec, STEPS)
    ms = program_spans.self_ms(rec, STEPS)
    if not steps or ms is None:
        return None
    return ms / steps
