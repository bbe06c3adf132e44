"""Percent of the traced window in which no kernel, copy or fill ran on
the device, in the searches cell."""


def read(rec):
    if rec.trace is None or not rec.searches:
        return None
    return rec.trace.idle_percent
