"""Host milliseconds of the server's admissions (self time of the
program's ``serve.admit`` spans: waiting queries given free lanes, their
tables set up) in the traced stretch, per query the engine answered
there (landmark answers aside)."""
from bench.harness import program_spans


def read(rec):
    return program_spans.ms_per_engine_query(rec, "serve.admit")
