"""Host milliseconds a batched superstep of the server's lanes spends
enqueueing its steps (the program's ``lane.step`` spans: the batched
step and the lanes stepped alone), on average over the traced
stretch."""
from bench.harness import program_spans


def read(rec):
    return program_spans.ms_each(rec, "lane.step")
