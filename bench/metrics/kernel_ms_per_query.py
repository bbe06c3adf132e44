"""Milliseconds the device was busy in the traced window, per query
answered in it."""


def read(rec):
    if rec.trace is None or rec.trace.busy_s <= 0:
        return None
    n = sum(rec.trace.start <= q["at"] <= rec.trace.end
            for q in rec.queries)
    if not n:
        return None
    return 1e3 * rec.trace.busy_s / n
