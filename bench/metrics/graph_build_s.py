"""Seconds in ``core/graph.from_edge_list`` (the benchmark's span
around the call)."""


def read(rec):
    return rec.spans.total("from_edge_list")
