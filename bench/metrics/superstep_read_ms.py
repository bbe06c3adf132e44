"""Host milliseconds a superstep of a search spends in the occupancy
read (self time of the program's ``run.read`` spans, where the host waits
for the device to drain), over the supersteps (``run.pull`` +
``run.push`` spans) of the traced stretch."""
from bench.harness import program_spans

STEPS = ("run.pull", "run.push")


def read(rec):
    steps = program_spans.count(rec, STEPS)
    ms = program_spans.self_ms(rec, "run.read")
    if not steps or ms is None:
        return None
    return ms / steps
