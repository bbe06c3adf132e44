"""The port's ``run_stats`` as the JAX package reports them.

The port's ``run()`` also reports its CUDA graphs' engagement
(``replayed_supersteps``, ``graph_captures``; ``core/step_graphs.py``),
which the JAX package has no counterpart of.  Parity tests compare the
rest.
"""

GRAPH_KEYS = ("replayed_supersteps", "graph_captures")


def jax_stats(stats: dict) -> dict:
    """``stats`` without :data:`GRAPH_KEYS`."""
    return {k: v for k, v in stats.items() if k not in GRAPH_KEYS}
