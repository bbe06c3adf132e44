"""Two faults of the port against the JAX package, each pinned.

1. A gather the tracer cannot follow gets its module fact from the
   16-element sampling probe (provenance ``probed``, as the JAX package's
   fact).  Only a ``static`` module may reach the kernels, which evaluate
   the menu module in place of the user's callable: a probed match runs
   the callable through the table or general route.  The program below
   equals ``plus_one`` on the probe batch and ``v * 2`` from 100 up; on
   a 120-vertex chain every mode and backend must give the callable's
   answer (vertex 101 = 200, not the menu's 101).
2. A float min/max settles a tie of +0 and -0 as the kernels do (-0 <
   +0) on the routes that reduce through torch's own order: the sparse
   backend's ``scatter_reduce_`` (``kernels/push_scatter.py``), the
   general streamed push (``core/stream.py``) and the dense plane's
   sub-row fold, ``subrow_combine`` and ``combine_rows``
   (``kernels/pull_bitmap.py``).  The graph sends +0 and -0 into one
   vertex, the winning zero last, so a sequential scatter or fold keeps
   the losing one.
"""
import numpy as np
import pytest

import jax.numpy as jnp
from repro.core import dsl as RD
from repro.core import graph as RG
from repro.core.translator import translate as rtranslate

import torch
from repro_torch.core import dsl
from repro_torch.core import graph as G
from repro_torch.core.analysis import analyze_program
from repro_torch.core.scheduler import DirectionPolicy, ScheduleConfig
from repro_torch.core.translator import translate
from torch_threads import one_thread  # noqa: F401

CPU = "cpu"
CHAIN = 120


def _coincidence_replay(V):
    """``where(v < 100, v + 1, v * 2)`` under min on the chain 0 → … →
    V-1 from root 0, superstep by superstep in numpy."""
    val = np.full(V, 2**20, np.int64)
    val[0] = 0
    active = np.zeros(V, bool)
    active[0] = True
    while active.any():
        src = np.flatnonzero(active[:-1])
        msg = np.full(V, np.iinfo(np.int32).max, np.int64)
        msg[src + 1] = np.where(val[src] < 100, val[src] + 1, val[src] * 2)
        new = np.minimum(val, msg)
        active = new != val
        val = new
    return val.astype(np.int32)


def _host_coincidence(v, w, d):
    if bool((v < 100).all()):        # data-dependent Python control flow
        return v + 1
    return torch.where(v < 100, v + 1, v * 2)


def _host_coincidence_jax(v, w, d):
    if bool(np.asarray(v < 100).all()):
        return v + 1
    return jnp.where(v < 100, v + 1, v * 2)


def _untraceable(pkg, gather, minimum, dtype):
    return pkg.VertexProgram(
        name="untraceable_coincidence", gather=gather, reduce="min",
        apply=minimum, init_value=2**20, frontier="changed",
        value_dtype=dtype)


def test_untraceable_coincidence_fact_is_the_jax_packages():
    """The module fact stays the probe's, with the JAX package's
    provenance: the repair is in what reaches the kernels."""
    from repro.core import analysis as RA
    t = analyze_program(_untraceable(dsl, _host_coincidence, torch.minimum,
                                     torch.int32))
    r = RA.analyze_program(_untraceable(RD, _host_coincidence_jax,
                                        jnp.minimum, jnp.int32))
    assert t.gather_module.value == "plus_one"
    assert t.gather_module.provenance == "probed"
    assert t.summary()["gather_module"] == r.summary()["gather_module"]


@pytest.mark.parametrize("backend", ["dense", "sparse"])
@pytest.mark.parametrize("mode", ["pull", "push", "auto"])
def test_untraceable_coincidence_runs_the_callable(mode, backend):
    """Every mode and backend gives the callable's answer, equal to the
    numpy replay bit for bit; no menu module is annotated."""
    V = CHAIN
    src = np.arange(V - 1, dtype=np.int32)
    chain = G.from_edge_list(src, src + 1, num_vertices=V)
    prog = translate(
        _untraceable(dsl, _host_coincidence, torch.minimum, torch.int32),
        chain, ScheduleConfig(backend=backend,
                              direction=DirectionPolicy(mode=mode)),
        device=CPU)
    got, _ = prog.run(roots=0)
    want = _coincidence_replay(V)
    assert int(got[101]) == 200
    np.testing.assert_array_equal(got.numpy(), want)
    assert prog.report.gather_module is None


def test_traced_coincidence_matches_the_untraceable_one():
    """The same function, traced (module None, static) and untraceable
    (module fact probed), and the JAX package's resident run of the
    traced spelling: one answer."""
    import jax
    V = CHAIN
    src = np.arange(V - 1, dtype=np.int32)
    chain = G.from_edge_list(src, src + 1, num_vertices=V)
    traced = dsl.VertexProgram(
        name="coincidence",
        gather=lambda v, w, d: torch.where(v < 100, v + 1, v * 2),
        reduce="min", apply=torch.minimum, init_value=2**20,
        frontier="changed", value_dtype=torch.int32)
    a, _ = translate(traced, chain, device=CPU).run(roots=0)
    b, _ = translate(_untraceable(dsl, _host_coincidence, torch.minimum,
                                  torch.int32), chain, device=CPU).run(
        roots=0)
    rprog = RD.VertexProgram(
        name="coincidence",
        gather=lambda v, w, d: jax.lax.select(v < 100, v + 1, v * 2),
        reduce="min", apply=jnp.minimum, init_value=2**20,
        frontier="changed", value_dtype=jnp.int32)
    rchain = RG.from_edge_list(src, src + 1, num_vertices=V)
    c, _ = rtranslate(rprog, rchain).run(roots=0)
    assert torch.equal(a, b)
    np.testing.assert_array_equal(a.numpy(), np.asarray(c))


# ---------------------------------------------------------------------------
# ±0 ties of a float min/max
# ---------------------------------------------------------------------------

# target vertex → its sources; the hub's 1,100 in-edges split into two
# max-width rows (1,024 slots), target 1's 12 into two sub-rows of 8
_V = 1200
_TARGETS = {0: range(100, 1200), 1: range(100, 112), 2: range(100, 104),
            3: range(100, 103)}


def _tie_graph(weight):
    src = np.concatenate([np.asarray(s, np.int32) for s in
                          _TARGETS.values()])
    dst = np.concatenate([np.full(len(s), t, np.int32)
                          for t, s in _TARGETS.items()])
    return G.from_edge_list(src, dst, num_vertices=_V,
                            weights=np.full(src.shape, weight, np.float32))


def _tie_values(reduce):
    """Sources hold the losing zero but for one winning zero at the end
    of targets 0–2's in-edges (the hub's in its second row); target 3
    sees only losing zeros.  Targets start at the identity."""
    lose, win = (0.0, -0.0) if reduce == "min" else (-0.0, 0.0)
    vals = np.full(_V, lose, np.float32)
    vals[[1199, 111, 103]] = win
    vals[:4] = np.inf if reduce == "min" else -np.inf
    return vals


def _tie_program(reduce, gather):
    return dsl.VertexProgram(
        name=f"tie_{reduce}", gather=gather, reduce=reduce,
        apply=torch.minimum if reduce == "min" else torch.maximum,
        init_value=float("inf") if reduce == "min" else float("-inf"),
        frontier="changed", value_dtype=torch.float32)


def _assert_settled(got, reduce):
    """Targets 0–2 hold the winning zero (-0 for a min, +0 for a max),
    target 3 the losing one."""
    got = torch.as_tensor(got)[:4]
    assert torch.equal(got, torch.zeros(4)), got
    neg = reduce == "min"
    assert torch.signbit(got).tolist() == [neg, neg, neg, not neg]


@pytest.mark.parametrize("reduce", ["min", "max"])
@pytest.mark.parametrize("route", ["dense_pull", "sparse_pull",
                                   "sparse_push"])
def test_zero_tie_settled_resident(route, reduce):
    """The dense plane's sub-row fold and row combines (``pull_bitmap``),
    and the sparse backend's scatter (``push_scatter``) in both
    directions: one superstep from every vertex active."""
    g = _tie_graph(1.0)
    backend, mode = route.split("_")
    prog = translate(_tie_program(reduce, lambda v, w, d: v), g,
                     ScheduleConfig(backend=backend,
                                    direction=DirectionPolicy(mode=mode)),
                     device=CPU)
    vals, active = prog.init_state(values=_tie_values(reduce))
    step = prog.superstep if mode == "pull" else prog.superstep_push
    new, _ = step(vals, active)
    _assert_settled(new, reduce)


@pytest.mark.parametrize("reduce", ["min", "max"])
def test_zero_tie_settled_streamed_general_push(reduce):
    """The streamed engine's general partial on the push plane (a
    weighted gather outside the menu, ``v + 2 * w`` with every weight
    -0, so that a source's zero passes through with its sign)."""
    g = _tie_graph(-0.0)
    prog = translate(_tie_program(reduce, lambda v, w, d: v + 2 * w), g,
                     ScheduleConfig(partitions=2,
                                    direction=DirectionPolicy(mode="push")),
                     device=CPU)
    assert prog._general
    got, _ = prog.run(values=_tie_values(reduce))
    _assert_settled(got, reduce)
