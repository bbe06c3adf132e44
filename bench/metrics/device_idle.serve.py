"""Percent of the traced window in which no kernel, copy or fill ran on
the device, in the served cell."""


def read(rec):
    if rec.trace is None or not rec.queries:
        return None
    return rec.trace.idle_percent
