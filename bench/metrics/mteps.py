"""Millions of Graph500-counted edges a second: for every search of the
window, the input tuples of the root's component (the benchmark's own
component labels), over the whole window."""


def read(rec):
    if not rec.searches:
        return None
    return sum(s["edges"] for s in rec.searches) / rec.window_s / 1e6
