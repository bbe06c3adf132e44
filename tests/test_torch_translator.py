"""Port parity: the resident single-device slice, end to end on the CPU.

bfs, sssp and wcc under pull, push and auto are bit-exact against the
JAX package in values, ``iters`` and the ``run_stats`` counters; the
float-add templates (pagerank, spmv, degree) agree within ``rtol=1e-5``,
the reassociation noise the JAX package documents for float sums.
"""
import numpy as np
import pytest

import jax.numpy as jnp
from repro.core import algorithms as RALG
from repro.core import dsl as RD
from repro.core import graph as RG
from repro.core import scheduler as RS
from repro.core import translator as RT

import torch
from repro_torch.core import algorithms as TALG
from repro_torch.core import comm as TC
from repro_torch.core import dsl as TD
from repro_torch.core import graph as G
from repro_torch.core import scheduler as TS
from repro_torch.core import translator as TT
from torch_stats import jax_stats
from torch_threads import one_thread  # noqa: F401

FLAVOR = {"dense_pallas": "dense_cuda", "dense_xla": "dense_torch"}
STATS = ("push_supersteps", "push_compacted_supersteps",
         "push_fallback_supersteps", "pull_supersteps", "direction_switches",
         "edges_traversed", "pull_cost_model", "terminated")


def _pair(V=1500, E=12000, seed=0):
    src, dst = RG.rmat_edges(V, E, seed=seed)
    w = np.random.default_rng(seed + 7).uniform(0.5, 4.0, len(src)) \
        .astype(np.float32)
    return (RG.from_edge_list(src, dst, num_vertices=V, weights=w),
            G.from_edge_list(src, dst, num_vertices=V, weights=w))


@pytest.fixture(scope="module")
def graphs():
    return _pair()


def _stats(s):
    return {k: s[k] for k in STATS}


def _same(ref, port):
    a, b = np.asarray(ref), port.cpu().numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("algo", ["bfs", "sssp", "wcc"])
@pytest.mark.parametrize("direction", ["pull", "push", "auto"])
def test_min_programs_bit_exact(graphs, algo, direction):
    rg, tg = graphs
    if algo == "wcc":
        rv, ri, rrep = RALG.wcc(rg, direction=direction)
        tv, ti, trep = TALG.wcc(tg, direction=direction, device="cpu")
    else:
        rv, ri, rrep = getattr(RALG, algo)(rg, 3, direction=direction)
        tv, ti, trep = getattr(TALG, algo)(tg, 3, direction=direction,
                                           device="cpu")
    _same(rv, tv)
    assert int(ri) == ti
    assert _stats(rrep.run_stats) == _stats(trep.run_stats)
    assert rrep.run_stats["push_live_rows_per_pe"] == \
        trep.run_stats["push_live_rows_per_pe"]
    assert FLAVOR[rrep.backend] == trep.backend == "dense_torch"
    assert rrep.push_tiers == trep.push_tiers


def test_push_shows_compacted_and_fallback(graphs):
    _, tg = graphs
    _, _, rep = TALG.bfs(tg, 0, direction="push", device="cpu")
    s = rep.run_stats
    assert s["push_compacted_supersteps"] > 0
    assert s["push_fallback_supersteps"] > 0


def test_pagerank_within_reassociation_tolerance(graphs):
    rg, tg = graphs
    rv, ri, _ = RALG.pagerank(rg, iters=15)
    tv, ti, trep = TALG.pagerank(tg, iters=15, device="cpu")
    assert int(ri) == ti == 15
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=1e-5)
    assert trep.run_stats["terminated"] == "budget"


def test_spmv_and_degree_within_tolerance(graphs):
    rg, tg = graphs
    x = np.random.default_rng(3).uniform(-1, 1, tg.num_vertices) \
        .astype(np.float32)
    ry, _ = RALG.spmv(rg, jnp.asarray(x))
    ty, _ = TALG.spmv(tg, x, device="cpu")
    np.testing.assert_allclose(ty.numpy(), np.asarray(ry), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(TALG.in_degrees(tg, device="cpu").numpy(),
                               np.asarray(RALG.in_degrees(rg)), rtol=1e-5)


@pytest.mark.parametrize("name,root", [("bfs", 0), ("sssp", 5)])
def test_against_pallas_interpret_path(graphs, name, root):
    """The JAX package with its Pallas kernels (interpret mode) on the
    dense pull sweep, against the port on the CPU."""
    rg, tg = graphs
    rprog = RT.translate(
        RD.PROGRAM_TEMPLATES[name](), rg,
        RS.ScheduleConfig(pull_sweep="dense"), use_pallas=True)
    rv, ri = rprog.run(roots=root)
    tprog = TT.translate(TD.PROGRAM_TEMPLATES[name](), tg,
                         TS.ScheduleConfig(pull_sweep="dense"), device="cpu")
    tv, ti = tprog.run(roots=root)
    assert rprog.report.backend == "dense_pallas"
    _same(rv, tv)
    assert int(ri) == ti
    assert _stats(rprog.report.run_stats) == _stats(tprog.report.run_stats)


def test_supersteps_and_budget_match(graphs):
    rg, tg = graphs
    cfg_r = RS.ScheduleConfig(max_supersteps=2)
    cfg_t = TS.ScheduleConfig(max_supersteps=2)
    rp = RT.translate(RD.bfs_program(), rg, cfg_r)
    tp = TT.translate(TD.bfs_program(), tg, cfg_t, device="cpu")
    rv, ri = rp.run(roots=0)
    tv, ti = tp.run(roots=0)
    _same(rv, tv)
    assert int(ri) == ti == 2
    assert _stats(rp.report.run_stats) == _stats(tp.report.run_stats)
    assert tp.report.run_stats["terminated"] == "budget"
    # the public single-superstep forms agree too
    v0, a0 = tp.init_state(roots=0)
    r0, b0 = rp.init_state(roots=0)
    for rstep, tstep in ((rp.superstep, tp.superstep),
                         (rp.superstep_push, tp.superstep_push)):
        rn, ra = rstep(r0, b0)
        tn, ta = tstep(v0, a0)
        _same(rn, tn)
        _same(ra, ta)


def test_divergence_probe_matches():
    """A NaN (0 * inf messages) freezes the frontier in both packages."""
    def prog(lib, maximum, dtype):
        return lib.VertexProgram(
            name="blowup", gather=lambda v, w, d: v * w, reduce="max",
            apply=maximum, init_value=0.0, frontier="changed",
            value_dtype=dtype)
    src, dst = RG.rmat_edges(200, 1600, seed=2)
    w = np.ones(len(src), np.float32)
    w[::7] = np.inf
    rg = RG.from_edge_list(src, dst, num_vertices=200, weights=w)
    tg = G.from_edge_list(src, dst, num_vertices=200, weights=w)
    rp = RT.translate(prog(RD, jnp.maximum, jnp.float32), rg,
                      RS.ScheduleConfig(probe_divergence=True))
    tp = TT.translate(prog(TD, torch.maximum, torch.float32), tg,
                      TS.ScheduleConfig(probe_divergence=True), device="cpu")
    rv, ri = rp.run()
    tv, ti = tp.run()
    np.testing.assert_array_equal(np.asarray(rv), tv.numpy())
    assert int(ri) == ti
    assert rp.report.run_stats["terminated"] == \
        tp.report.run_stats["terminated"] == "diverged"


def test_report_and_comm(graphs):
    _, tg = graphs
    comm = TC.CommManager()
    g = comm.transport(tg, device="cpu")
    assert comm.stats.host_to_device_bytes > 0
    levels, iters, rep = TALG.bfs(g, 0, comm=comm, device="cpu")
    assert rep.device == "cpu" and rep.directions == ("pull", "push")
    assert rep.translate_breakdown["build_s"] == 0.0
    assert "superstep bfs" in rep.ir_dump
    host = comm.fetch(levels)
    assert comm.stats.device_to_host_bytes == host.numel() * 4
    assert TALG.traversed_edges(g, levels) > 0
    assert comm.report(device="cpu")["platform"] == "cpu"


def test_default_device_is_cuda_and_never_falls_back(graphs, monkeypatch):
    _, tg = graphs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.translate(TD.bfs_program(), tg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TALG.bfs(tg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TC.CommManager().transport(tg)


def test_unported_paths_raise_with_roadmap_item(graphs, tmp_path):
    """Paths once refused until their ROADMAP item was ported.  Several
    PEs (refused until the multi-PE port) give the JAX package's values
    and every ``run_stats`` entry at the same PE count, on a PE group of
    two CPU devices.  Streamed
    partitions (a plan over 3 partitions, or a partition container as the
    source), refused until the streamed engine was ported, now give the
    JAX package's streamed answers and counters, and a source that is
    neither fails in both packages alike; batched runs and checkpointed
    runs, refused until the lane API was ported, give the JAX package's
    answers."""
    from repro.data import graphs as RDATA
    from repro_torch.core.stream import PartitionedGraphProgram
    from repro_torch.data import graphs as TDATA
    rg, tg = graphs
    rprog = RT.translate(RD.bfs_program(), rg, RS.ScheduleConfig(pes=2))
    prog = TT.translate(TD.bfs_program(), tg, TS.ScheduleConfig(pes=2),
                        device="cpu", devices=["cpu"] * 2)
    assert prog.report.pes == rprog.report.pes == 2
    rv, ri = rprog.run(roots=0)
    tv, ti = prog.run(roots=0)
    _same(rv, tv)
    assert int(ri) == ti
    assert rprog.last_run_stats == jax_stats(prog.last_run_stats)
    path = TDATA.container_from_graph(str(tmp_path / "c.npz"), tg, 3)
    for rsrc, tsrc, kw in (
            (rg, tg, dict(partitions=3)),
            (RDATA.load_partition_container(path),
             TDATA.load_partition_container(path), {})):
        rprog = RT.translate(RD.bfs_program(), rsrc, RS.ScheduleConfig(**kw))
        prog = TT.translate(TD.bfs_program(), tsrc, TS.ScheduleConfig(**kw),
                            device="cpu")
        assert isinstance(prog, PartitionedGraphProgram)
        assert prog.report.num_partitions == rprog.report.num_partitions == 3
        rv, ri = rprog.run(roots=0)
        tv, ti = prog.run(roots=0)
        _same(rv, tv)
        assert int(ri) == ti
        for key in ("partitions_swept", "partitions_skipped",
                    "partition_bytes_h2d", *STATS):
            assert rprog.last_run_stats[key] == prog.last_run_stats[key], key
    with pytest.raises(AttributeError):
        RT.translate(RD.bfs_program(), object())
    with pytest.raises(AttributeError):
        TT.translate(TD.bfs_program(), object(), device="cpu")
    rprog = RT.translate(RD.bfs_program(), rg)
    prog = TT.translate(TD.bfs_program(), tg, device="cpu",
                        checkpoint_dir=str(tmp_path))
    rv, ri = rprog.run_batch(np.asarray([0, 1]))
    tv, ti = prog.run_batch([0, 1])
    _same(rv, tv)
    np.testing.assert_array_equal(np.asarray(ri), ti.numpy())
    assert rprog.last_run_stats == prog.last_run_stats
    rv, ri = rprog.run(roots=3, checkpoint_dir=str(tmp_path / "jax"))
    tv, ti = prog.run(roots=3)
    _same(rv, tv)
    assert int(ri) == ti
    assert _stats(rprog.last_run_stats) == _stats(prog.last_run_stats)
    assert prog.last_run_stats["checkpoint_saves"] == \
        rprog.last_run_stats["checkpoint_saves"]


@pytest.mark.parametrize("pes", [1, 2])
def test_eager_runs_report_no_graph_replays(graphs, pes):
    """Off the CUDA graph path (here: the CPU, and a PE group of two CPU
    devices) ``run_stats`` read ``replayed_supersteps`` and
    ``graph_captures`` 0 and every other key is the JAX package's, at the
    first run and after it; the program counts no replay."""
    rg, tg = graphs
    rprog = RT.translate(RD.bfs_program(), rg, RS.ScheduleConfig(pes=pes))
    prog = TT.translate(TD.bfs_program(), tg, TS.ScheduleConfig(pes=pes),
                        device="cpu", devices=["cpu"] * pes)
    assert prog.report.pes == pes
    for root in (0, 3, 0):
        rv, ri = rprog.run(roots=root)
        tv, ti = prog.run(roots=root)
        _same(rv, tv)
        assert int(ri) == ti
        s = prog.last_run_stats
        assert s["replayed_supersteps"] == s["graph_captures"] == 0
        assert rprog.last_run_stats == jax_stats(s)
    assert prog.graph_replays == 0
