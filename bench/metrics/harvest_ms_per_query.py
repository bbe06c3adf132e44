"""Host milliseconds of the server's harvests (self time of the
program's ``serve.harvest`` spans, the finished lanes' tables copied to
the host) in the traced stretch, per query the engine answered there
(landmark answers aside)."""
from bench.harness import program_spans


def read(rec):
    return program_spans.ms_per_engine_query(rec, "serve.harvest")
