"""Queries answered in the window, over the window."""


def read(rec):
    if not rec.queries:
        return None
    return len(rec.queries) / rec.window_s
