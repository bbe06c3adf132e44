from . import (decode_gqa, edge_block, ops, pull_bitmap, push_ell,
               push_scatter, ref, segment_sum)

__all__ = ["decode_gqa", "edge_block", "ops", "pull_bitmap", "push_ell",
           "push_scatter", "ref", "segment_sum", "add_launch_counts",
           "launch_counts", "set_launch_counts"]

_WRAPPERS = (decode_gqa, edge_block, push_ell, push_scatter, segment_sum)


def launch_counts() -> dict:
    """Every kernel wrapper's launch counters, ``{(function, attribute):
    count}``: the integer attributes named ``*launches`` that a wrapper
    bumps each time it launches its kernel."""
    out = {}
    for mod in _WRAPPERS:
        for fn in vars(mod).values():
            if not callable(fn) or not hasattr(fn, "__dict__"):
                continue
            for attr, n in vars(fn).items():
                if attr.endswith("launches") and type(n) is int:
                    out[(fn, attr)] = n
    return out


def set_launch_counts(counts: dict) -> None:
    """Set the counters to ``counts`` (a :func:`launch_counts` reading)."""
    for (fn, attr), n in counts.items():
        setattr(fn, attr, n)


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` (``{(function, attribute): launches}``) to the
    counters."""
    for (fn, attr), n in delta.items():
        setattr(fn, attr, getattr(fn, attr) + n)
