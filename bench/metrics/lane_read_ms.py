"""Host milliseconds a batched superstep of the server's lanes spends in
its occupancy read (the program's ``lane.read`` spans, where the host
waits for the device to drain), on average over the traced stretch."""
from bench.harness import program_spans


def read(rec):
    return program_spans.ms_each(rec, "lane.read")
