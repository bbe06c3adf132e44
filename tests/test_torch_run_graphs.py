"""The run loop's CUDA graphs (``repro_torch/core/step_graphs.py``).

A single-PE plan on the dense pull plane, on CUDA, replays a CUDA graph a
superstep.  These tests hold a graphed ``run()`` against the eager loop
on the CPU (the kernels' plain versions) on a scale-13 R-MAT graph:

* bfs under auto, push and pull and sssp (float, NaN probe on): values
  bit for bit, ``run_stats`` less the two engagement keys, ``iters`` and
  ``last_run_syncs`` equal;
* pagerank: bit for bit the eager supersteps on the card, and within the
  float-add tolerance of the CPU run;
* ``replayed_supersteps`` equals the supersteps, ``graph_captures`` is
  nonzero at the first run only, ``graph_replays`` accumulates;
* successive runs return tensors of their own;
* the kernels' launch counters grow by what the eager loop launches;
* the bitmap plane, a PE group, the sparse backend and a checkpointed run
  keep the eager loop.

They need an NVIDIA GPU (marker ``cuda``) and skip without one.  On a
machine with one: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_run_graphs.py``.  The file imports no JAX: the card's
tests compare with the port's own plain versions.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import dsl as TD
from repro_torch.core import graph as G
from repro_torch.core import scheduler as TS
from repro_torch.core import translator as TT
from repro_torch.kernels import edge_block as eb
from repro_torch.kernels import push_ell as pe
from torch_stats import GRAPH_KEYS, jax_stats
from torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.cuda

SCALE = 13
CASES = [("bfs", "auto"), ("bfs", "push"), ("bfs", "pull"), ("sssp", "auto")]


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def graph():
    V = 1 << SCALE
    src, dst = G.rmat_edges(V, 16 * V, seed=5)
    w = np.random.default_rng(5).uniform(0.5, 4.0, len(src)) \
        .astype(np.float32)
    return G.from_edge_list(src, dst, num_vertices=V, weights=w)


def _roots(g) -> list:
    """The hub, a vertex of middling degree and one of degree 1."""
    deg = g.out_degrees.numpy()
    order = np.argsort(-deg, kind="stable")
    return [int(order[0]), int(order[len(order) // 8]),
            int(np.flatnonzero(deg == 1)[0])]


def _translate(g, name, mode, device, **kw):
    cfg = TS.ScheduleConfig(direction=TS.DirectionPolicy(mode=mode),
                            probe_divergence=name == "sssp", **kw)
    return TT.translate(TD.PROGRAM_TEMPLATES[name](), g, cfg, device=device)


def _bits(t):
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("name,mode", CASES)
def test_graphed_run_equals_eager_cpu_run(cuda, graph, name, mode):
    gp = _translate(graph, name, mode, cuda)
    cp = _translate(graph, name, mode, "cpu")
    replays = 0
    for i, root in enumerate(_roots(graph)):
        gv, gi = gp.run(roots=root)
        cv, ci = cp.run(roots=root)
        assert torch.equal(_bits(gv), _bits(cv)), (name, mode, root)
        assert gi == ci
        gs, cs = gp.last_run_stats, cp.last_run_stats
        assert jax_stats(gs) == jax_stats(cs)
        assert gp.last_run_syncs == cp.last_run_syncs
        assert gs["replayed_supersteps"] == gi == \
            gs["push_supersteps"] + gs["pull_supersteps"]
        assert (gs["graph_captures"] > 0) == (i == 0)
        assert all(cs[k] == 0 for k in GRAPH_KEYS)
        replays += gi + 1
    assert gp.graph_replays == replays and cp.graph_replays == 0


def test_graphed_pagerank(cuda, graph):
    gp = _translate(graph, "pagerank", "pull", cuda)
    cp = _translate(graph, "pagerank", "pull", "cpu")
    for first in (True, False):
        gv, gi = gp.run()
        cv, ci = cp.run()
        assert gi == ci == 20
        v, a = gp.init_state()
        for _ in range(gi):
            v, a = gp.superstep(v, a)
        assert torch.equal(_bits(gv), _bits(v))
        np.testing.assert_allclose(gv.cpu().numpy(), cv.numpy(), rtol=1e-5)
        gs = gp.last_run_stats
        assert jax_stats(gs) == jax_stats(cp.last_run_stats)
        assert gp.last_run_syncs == cp.last_run_syncs
        assert gs["replayed_supersteps"] == 20
        assert (gs["graph_captures"] > 0) == first


@pytest.mark.parametrize("mode", ["push", "auto"])
def test_graphed_runs_own_results_and_count_launches(cuda, graph, mode):
    prog = _translate(graph, "bfs", mode, cuda)
    kept, compacted, fallback = [], 0, 0
    for root in _roots(graph) * 2:
        before = kernels.launch_counts()
        v, _ = prog.run(roots=root)
        after = kernels.launch_counts()

        def grew(fn, attr):
            return after[(fn, attr)] - before[(fn, attr)]

        s = prog.last_run_stats
        sweeps = s["pull_supersteps"] + s["push_fallback_supersteps"]
        assert grew(eb.edge_block_reduce, "launches") == sweeps
        assert grew(eb.edge_block_prepare, "launches") == sweeps
        assert grew(pe.push_ell_fused_reduce, "launches") == \
            s["push_compacted_supersteps"]
        compacted += s["push_compacted_supersteps"]
        fallback += s["push_fallback_supersteps"]
        kept.append((v, v.clone()))
    assert compacted > 0 and fallback > 0
    assert len({v.data_ptr() for v, _ in kept}) == len(kept)
    for v, copy in kept:
        assert torch.equal(v, copy)


@pytest.mark.parametrize("plan", ["bitmap", "pes2", "sparse", "checkpoint"])
def test_other_plans_keep_the_eager_loop(cuda, graph, plan, tmp_path):
    root = _roots(graph)[0]
    want, _ = _translate(graph, "bfs", "auto", cuda).run(roots=root)
    kw, run_kw = {}, {}
    if plan == "bitmap":
        kw = {"pull_sweep": "bitmap"}
    elif plan == "sparse":
        kw = {"backend": "sparse"}
    elif plan == "checkpoint":
        run_kw = {"checkpoint_dir": str(tmp_path)}
    if plan == "pes2":
        prog = TT.translate(TD.bfs_program(), graph, TS.ScheduleConfig(pes=2),
                            device=cuda, devices=[cuda] * 2)
        assert prog.report.pes == 2
    else:
        prog = _translate(graph, "bfs", "auto", cuda, **kw)
    v, _ = prog.run(roots=root, **run_kw)
    assert torch.equal(v, want)
    s = prog.last_run_stats
    assert all(s[k] == 0 for k in GRAPH_KEYS)
    assert prog.graph_replays == 0
