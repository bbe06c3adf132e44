"""Port parity: multi-PE execution on a PE group of CPU devices.

Case for case with ``tests/test_multi_pe.py``.  The port's PEs are a
device list (``devices=["cpu"] * p``), the JAX package's a mesh over the
conftest's eight host devices.  Under jax 0.9 the JAX package runs the
dense sharded push in a single ``run`` but not its sparse exchange nor its
multi-PE ``run_batch`` (``ROADMAP.md``, Open items), so:

* the dense sharded push (bfs, sssp, wcc × push, auto × 2 and 4 PEs) is
  held against the JAX package at the same PE count: values, ``iters``
  and every ``run_stats`` entry, exchange counters included;
* the sparse exchange, batched and sliced lanes, checkpoints and the
  server are held against the JAX package at one PE (exact for min, max
  and integer add, ``rtol=1e-5`` for a float add, whose PE-order sum
  reassociates) and against the port's own sequential ``pes=p`` runs;
* the collectives are held against the JAX functions under
  ``jax.vmap(axis_name="pe")``: ``quantized_psum`` and ``bitmap_or`` bit
  for bit.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.core import checkpoint as RC
from repro.core import dsl as RD
from repro.core import graph as RG
from repro.core import scheduler as RS
from repro.core import translator as RT
from repro.core.comm import CommManager as RComm

import torch
from repro_torch.core import algorithms as TALG
from repro_torch.core import checkpoint as ckpt
from repro_torch.core import comm as TC
from repro_torch.core import dsl as TD
from repro_torch.core import faults
from repro_torch.core import graph as G
from repro_torch.core import preprocess as TP
from repro_torch.core import scheduler as TS
from repro_torch.core import translator as TT
from repro_torch.errors import CheckpointMismatchError, InjectedFault
from repro_torch.serve.graph_serve import GraphServer
from torch_stats import jax_stats
from torch_threads import one_thread  # noqa: F401

CPU = "cpu"
TEMPLATES = ("bfs", "sssp", "wcc")
FLOAT_ADD = ("pagerank", "ppr", "spmv", "degree")


def _cpus(p):
    return [CPU] * p


@pytest.fixture(scope="module")
def graphs():
    src, dst = RG.rmat_edges(400, 4000, seed=11)      # avg degree 10: dense
    w = np.random.default_rng(11).uniform(0.5, 2, len(src)).astype(np.float32)
    return (RG.from_edge_list(src, dst, num_vertices=400, weights=w),
            G.from_edge_list(src, dst, num_vertices=400, weights=w))


def _cfg(mod, pes, mode="auto", **kw):
    return mod.ScheduleConfig(pes=pes,
                              direction=mod.DirectionPolicy(mode=mode), **kw)


def _roots(program):
    return 0 if program.frontier == "changed" else None


_JAX1: dict = {}


def _jax_pes1(rg, name, backend="auto"):
    """The JAX package's one-PE run of a template (memoized)."""
    key = (name, backend)
    if key not in _JAX1:
        program = RD.PROGRAM_TEMPLATES[name]()
        prog = RT.translate(program, rg, _cfg(RS, 1, backend=backend))
        vals, iters = prog.run(roots=_roots(program))
        _JAX1[key] = (np.asarray(vals), int(iters))
    return _JAX1[key]


def _agree(name, want, got):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    if name in FLOAT_ADD:
        np.testing.assert_allclose(want, got, rtol=1e-5, err_msg=name)
    else:
        assert want.dtype == got.dtype, (want.dtype, got.dtype)
        np.testing.assert_array_equal(want, got, err_msg=name)


# ---------------------------------------------------------------------------
# 1. the per-PE forward-ELL interval partition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pes", [1, 2, 3, 4, 7])
def test_sharded_forward_ell_partition(graphs, pes):
    """Array for array the JAX layout; the port's vertex bounds give each
    PE exactly its interval's rows."""
    rg, tg = graphs
    want = RG.shard_forward_ell(RG.forward_ell(rg), pes)
    fe = G.forward_ell(tg)
    got = G.shard_forward_ell(fe, pes)
    for f in ("row_src", "dst", "weights", "row_valid"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    for f in ("rows_per_pe", "edges_per_pe", "rows_per_pe_max", "pes",
              "width", "num_vertices", "num_edges"):
        assert getattr(want, f) == getattr(got, f), f
    assert sum(got.rows_per_pe) == fe.num_rows
    assert sum(got.edges_per_pe) == tg.num_edges
    rpv = fe.rows_per_vertex.numpy()
    cuts = got.vertex_cuts
    assert cuts[0] == 0 and cuts[-1] == tg.num_vertices
    for p in range(pes):
        assert rpv[cuts[p]:cuts[p + 1]].sum() == got.rows_per_pe[p]
        rs, dst, _ = got.interval(p)
        n = got.rows_per_pe[p]
        assert rs.shape == (n,) and dst.shape == (n, fe.width)
        assert ((rs >= cuts[p]) & (rs < cuts[p + 1])).all()
    if pes > 1:
        fair = tg.num_edges / pes
        hub = int(tg.out_degrees.max())
        assert max(got.edges_per_pe) <= 2 * fair + hub


def test_shard_forward_ell_edgeless():
    src = np.array([], np.int32)
    rg0 = RG.from_edge_list(src, src, num_vertices=5)
    tg0 = G.from_edge_list(src, src, num_vertices=5)
    want = RG.shard_forward_ell(RG.forward_ell(rg0), 3)
    got = G.shard_forward_ell(G.forward_ell(tg0), 3)
    assert got.rows_per_pe == want.rows_per_pe == (0, 0, 0)
    assert got.edges_per_pe == want.edges_per_pe == (0, 0, 0)
    np.testing.assert_array_equal(np.asarray(want.dst), got.dst.numpy())
    assert got.vertex_cuts[-1] == 5


def test_shards_cached_budgeted_and_placed(graphs):
    """Memoized per (width, pes), counted in the cache's bytes, and each
    PE's interval placed (copied once) on its device."""
    _, tg = graphs
    lay = TP.layouts_for(tg)
    before = lay.nbytes()
    sfe = lay.forward_ell_shards(8, 3)
    assert lay.forward_ell_shards(8, 3) is sfe
    assert lay.nbytes() > before
    assert "forward_ell_shards_w8_p3" in lay.stats()["products"]
    for p in range(3):
        placed = lay.on_pe(sfe, p, CPU)
        assert lay.on_pe(sfe, p, CPU) is placed
        for a, b in zip(placed, sfe.interval(p)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# 2. the dense sharded push, bit-exact against the JAX package at pes=p
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pes", [2, 4])
@pytest.mark.parametrize("mode", ["push", "auto"])
@pytest.mark.parametrize("template", TEMPLATES)
def test_push_bit_exact_across_pes(graphs, template, mode, pes):
    rg, tg = graphs
    rprog = RT.translate(RD.PROGRAM_TEMPLATES[template](), rg,
                         _cfg(RS, pes, mode))
    prog = TT.translate(TD.PROGRAM_TEMPLATES[template](), tg,
                        _cfg(TS, pes, mode), device=CPU, devices=_cpus(pes))
    roots = 0 if template != "wcc" else None
    rv, ri = rprog.run(roots=roots)
    tv, ti = prog.run(roots=roots)
    _agree(template, np.asarray(rv), tv)
    assert int(ri) == ti
    assert rprog.last_run_stats == jax_stats(prog.last_run_stats)
    rep, rrep = prog.report, rprog.report
    for f in ("pes", "directions", "exchange_plane", "exchange_quantized",
              "push_pe_rows", "push_pe_edges", "push_tiers",
              "est_collective_bytes", "est_frontier_bytes"):
        assert getattr(rep, f) == getattr(rrep, f), f
    assert rep.pes == pes and rep.exchange_plane == "push"
    s = prog.last_run_stats
    assert s["push_supersteps"] >= 1
    assert len(s["push_live_rows_per_pe"]) == pes
    assert s["exchange_supersteps"] == s["push_compacted_supersteps"] > 0
    assert s["exchange_bytes"] == \
        s["exchange_supersteps"] * rep.est_collective_bytes


@pytest.mark.parametrize("template", ["bfs", "sssp"])
def test_bitmap_plane_under_multi_pe(graphs, template):
    """The block-skipping pull plane stays replicated beside the sharded
    push: equal to the JAX package at pes=2; its lanes (batched
    supersteps, the pull lanes through 2L) equal the sequential runs."""
    rg, tg = graphs
    rprog = RT.translate(RD.PROGRAM_TEMPLATES[template](), rg,
                         RS.ScheduleConfig(pes=2, pull_sweep="bitmap"))
    prog = TT.translate(TD.PROGRAM_TEMPLATES[template](), tg,
                        TS.ScheduleConfig(pes=2, pull_sweep="bitmap"),
                        device=CPU, devices=_cpus(2))
    rv, ri = rprog.run(roots=0)
    tv, ti = prog.run(roots=0)
    _agree(template, np.asarray(rv), tv)
    assert int(ri) == ti
    assert rprog.last_run_stats == jax_stats(prog.last_run_stats)
    assert prog.report.pull_sweep == "bitmap"
    assert prog.report.exchange_plane == "push"
    roots = [0, 5, 9]
    bv, bi = prog.run_batch(roots)
    _lane_equals_sequential(prog, bv, bi, prog.last_run_stats, roots)


def test_all_templates_translate_and_match_under_multi_pe(graphs):
    """Every template at pes=2 (sharded push, sparse pull exchange, or a
    replicated dense pull) against the JAX package at one PE."""
    rg, tg = graphs
    for name, factory in TD.PROGRAM_TEMPLATES.items():
        program = factory()
        want, iters = _jax_pes1(rg, name)
        vals, it = TT.translate(program, tg, _cfg(TS, 2), device=CPU,
                                devices=_cpus(2)).run(roots=_roots(program))
        assert it == iters, name
        _agree(name, want, vals)


def test_multi_pe_legality_notes(graphs):
    """Legal programs note the PE count; an overwrite apply and the sparse
    plan pin to pull with the multi-PE reasons."""
    _, tg = graphs
    c = TT.translate(TD.bfs_program(TALG.INT_MAX), tg, _cfg(TS, 2),
                     device=CPU, devices=_cpus(2), dump_passes=True)
    assert "push legal across pes=2" in c.report.pass_report
    assert "exchange: push plane (pes=2, pmin" in c.report.pass_report
    prog = TD.VertexProgram(
        name="overwrite", gather=lambda v, w, d: v + 1, reduce="min",
        apply=lambda old, s: s, init_value=2**30, value_dtype=torch.int32)
    c2 = TT.translate(prog, tg, _cfg(TS, 2), device=CPU, devices=_cpus(2),
                      dump_passes=True)
    assert c2.report.directions == ("pull",)
    assert c2.report.pes == 1 and c2.report.exchange_plane is None
    assert "identity-fixpoint" in c2.report.pass_report
    c3 = TT.translate(TD.bfs_program(TALG.INT_MAX), tg,
                      _cfg(TS, 2, backend="sparse"), device=CPU,
                      devices=_cpus(2), dump_passes=True)
    assert c3.report.directions == ("pull",)
    assert "sparse plan shards the pull plane" in c3.report.pass_report
    assert c3.report.exchange_plane == "pull" and c3.report.pes == 2


def test_pe_devices_must_match_the_run_device(graphs):
    _, tg = graphs
    with pytest.raises(ValueError, match="device type"):
        TT.translate(TD.bfs_program(), tg, _cfg(TS, 2), device=CPU,
                     devices=["cpu", "meta"])


# ---------------------------------------------------------------------------
# 3. plan geometry and degenerate graphs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pes", [1, 2, 3])
def test_plan_geometry_matches_staged_arrays(graphs, pes):
    """The plan's chunk geometry is the JAX plan's and what the sparse
    module stages (pes=3 does not divide 8 pipelines)."""
    rg, tg = graphs
    cfg = TS.ScheduleConfig(pipelines=8, pes=pes, backend="sparse")
    p = TS.plan(cfg, num_vertices=tg.num_vertices, num_edges=tg.num_edges,
                devices=_cpus(pes))
    rp = RS.plan(RS.ScheduleConfig(pipelines=8, pes=pes, backend="sparse"),
                 num_vertices=rg.num_vertices, num_edges=rg.num_edges)
    assert (p.pes, p.num_chunks, p.chunk_size) == \
        (rp.pes, rp.num_chunks, rp.chunk_size)
    assert p.describe() == rp.describe()
    c = TT.translate(TD.bfs_program(TALG.INT_MAX), tg, cfg, device=CPU,
                     devices=_cpus(pes), dump_passes=True)
    assert c.report.staged_chunks == (p.num_chunks, p.chunk_size)
    assert c.report.pipelines == p.num_chunks
    assert p.num_chunks % p.pes == 0
    assert p.num_chunks * p.chunk_size >= tg.num_edges
    assert p.describe() in c.report.pass_report


def test_plan_edgeless_graph_geometry():
    p = TS.plan(TS.ScheduleConfig(pes=4), num_vertices=10, num_edges=0,
                devices=_cpus(4))
    assert p.pes == 4 and p.num_chunks == 4 and p.chunk_size >= 1


@pytest.mark.parametrize("pes", [1, 2])
@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_edgeless_graph_end_to_end(pes, backend):
    src = np.array([], np.int32)
    g0 = G.from_edge_list(src, src, num_vertices=6)
    cfg = _cfg(TS, pes, backend=backend)
    lv, it = TT.translate(TD.bfs_program(TALG.INT_MAX), g0, cfg, device=CPU,
                          devices=_cpus(pes)).run(roots=2)
    want = np.full(6, TALG.INT_MAX)
    want[2] = 0
    np.testing.assert_array_equal(lv.numpy(), want)
    assert it == 1
    labels, _ = TT.translate(TD.wcc_program(), g0, cfg, device=CPU,
                             devices=_cpus(pes)).run()
    np.testing.assert_array_equal(labels.numpy(), np.arange(6))


def test_elastic_degrade_replan_multi_pe(graphs):
    """plan_for_devices clamps to the surviving pool; more PEs than
    devices degrade (no failure) and stay bit-exact; a bare ``pes`` on a
    CPU run takes the one CPU."""
    rg, tg = graphs
    meta = dict(num_vertices=tg.num_vertices, num_edges=tg.num_edges)
    p = TS.plan_for_devices(TS.ScheduleConfig(pes=8), 3, devices=_cpus(8),
                            **meta)
    rp = RS.plan_for_devices(RS.ScheduleConfig(pes=8), 3, **meta)
    assert p.pes == rp.pes == 3 and p.num_chunks % 3 == 0
    assert p.num_chunks == rp.num_chunks
    want, _ = _jax_pes1(rg, "bfs")
    prog = TT.translate(TD.bfs_program(), tg, _cfg(TS, 16), device=CPU,
                        devices=_cpus(8))
    vals, _ = prog.run(roots=0)
    assert prog.report.pes == 8
    np.testing.assert_array_equal(want, vals.numpy())
    bare = TT.translate(TD.bfs_program(), tg, _cfg(TS, 4), device=CPU)
    assert bare.report.pes == 1
    assert TS.default_devices("cpu") == [torch.device("cpu")]


# ---------------------------------------------------------------------------
# 4. the sparse pull exchange, quantization and its escape hatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pes", [2, 3])
@pytest.mark.parametrize("template", TEMPLATES + ("pagerank",))
def test_sparse_exchange_matches_jax_single_pe(graphs, template, pes):
    rg, tg = graphs
    want, iters = _jax_pes1(rg, template, backend="sparse")
    program = TD.PROGRAM_TEMPLATES[template]()
    prog = TT.translate(program, tg, _cfg(TS, pes, backend="sparse"),
                        device=CPU, devices=_cpus(pes))
    vals, it = prog.run(roots=_roots(program))
    assert it == iters
    _agree(template, want, vals)
    rep, s = prog.report, prog.last_run_stats
    assert rep.exchange_plane == "pull" and not rep.exchange_quantized
    assert rep.est_collective_bytes == \
        int(2 * (pes - 1) / pes * tg.num_vertices * 4)
    assert rep.est_frontier_bytes == (pes - 1) * (-(-tg.num_vertices // 32)) * 4
    assert s["exchange_supersteps"] == s["pull_supersteps"] == it
    assert s["exchange_bytes"] == it * (rep.est_collective_bytes
                                        + rep.est_frontier_bytes)


def test_quantized_exchange_pagerank_tolerance(graphs):
    """Full precision at pes=4 within reassociation of pes=1 (the JAX
    package's too); int8 within d/(1-d) · pes · scale of pes=1."""
    rg, tg = graphs
    iters, damping = 10, 0.85
    want, _ = (np.asarray(a) for a in RT.translate(
        RD.pagerank_program(damping, iters), rg,
        RS.ScheduleConfig(backend="sparse")).run())
    r1, _, _ = TALG.pagerank(tg, iters=iters, damping=damping, pes=1,
                             backend="sparse", device=CPU)
    r4, _, rep4 = TALG.pagerank(tg, iters=iters, damping=damping, pes=4,
                                backend="sparse", device=CPU,
                                devices=_cpus(4))
    assert rep4.exchange_plane == "pull" and not rep4.exchange_quantized
    np.testing.assert_allclose(r1.numpy(), r4.numpy(), rtol=1e-5)
    np.testing.assert_allclose(want, r4.numpy(), rtol=1e-5)
    cq = TT.translate(TD.pagerank_program(damping, iters), tg,
                      TS.ScheduleConfig(pes=4, backend="sparse",
                                        message_dtype="int8"),
                      device=CPU, devices=_cpus(4))
    rq, _ = cq.run()
    assert cq.report.exchange_quantized
    assert "A006" in {d.code for d in cq.report.diagnostics}
    assert cq.report.est_collective_bytes == \
        int(2 * 3 / 4 * tg.num_vertices) + 2 * int(2 * 3 / 4 * 4)
    scale = r1.abs().max().item() / 127.0
    bound = damping / (1 - damping) * cq.report.pes * scale + 1e-6
    assert (rq - r1).abs().max().item() <= bound


def test_quantization_escape_hatch_keeps_min_reduce_exact(graphs):
    rg, tg = graphs
    want, _ = _jax_pes1(rg, "bfs", backend="sparse")
    c = TT.translate(TD.bfs_program(TALG.INT_MAX), tg,
                     TS.ScheduleConfig(pes=2, backend="sparse",
                                       message_dtype="int8"),
                     device=CPU, devices=_cpus(2))
    lv, _ = c.run(roots=0)
    assert not c.report.exchange_quantized
    assert "A006" not in {d.code for d in c.report.diagnostics}
    np.testing.assert_array_equal(want, lv.numpy())


def test_pes16_mask_takes_the_int8_max(graphs, monkeypatch):
    """At 16 PEs the touched masks combine by an int8 max, not the packed
    bitmap (its wire is no smaller there); the run stays exact."""
    rg, tg = graphs
    want, _ = _jax_pes1(rg, "bfs", backend="sparse")

    def refuse(*a, **k):
        raise AssertionError("bitmap_or at 16 PEs")

    monkeypatch.setattr(TC, "bitmap_or", refuse)
    c = TT.translate(TD.bfs_program(TALG.INT_MAX), tg,
                     _cfg(TS, 16, backend="sparse"), device=CPU,
                     devices=_cpus(16))
    lv, _ = c.run(roots=0)
    np.testing.assert_array_equal(want, lv.numpy())
    assert c.report.est_frontier_bytes == int(2 * 15 / 16 * tg.num_vertices)


# ---------------------------------------------------------------------------
# 5. the collectives against the JAX functions under vmap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pes", [2, 3, 4, 7])
@pytest.mark.parametrize("V", [1, 67, 1000])
def test_collectives_match_jax(pes, V):
    rng = np.random.default_rng(pes * 1000 + V)
    for mag in (1e-3, 1.0, 1e4):
        x = (rng.normal(size=(pes, V)) * mag).astype(np.float32)
        want = np.asarray(jax.vmap(
            lambda a: RComm.quantized_psum(a, "pe", pes=pes),
            axis_name="pe")(jnp.asarray(x)))
        got = TC.quantized_psum([torch.from_numpy(r) for r in x]).numpy()
        assert (want == want[0]).all()            # replicated
        np.testing.assert_array_equal(want[0].view(np.int32),
                                      got.view(np.int32))
    mask = rng.random((pes, V)) < 0.3
    want = np.asarray(jax.vmap(
        lambda a: RComm.bitmap_or(RG.pack_bits(a), "pe", pes=pes),
        axis_name="pe")(jnp.asarray(mask)))
    got = TC.bitmap_or([G.pack_bits(torch.from_numpy(r)) for r in mask])
    np.testing.assert_array_equal(want[0].astype(np.int64), got.numpy())
    np.testing.assert_array_equal(G.unpack_bits(got, V).numpy(),
                                  mask.any(axis=0))
    ints = rng.integers(-50, 50, size=(pes, V)).astype(np.int32)
    parts = [torch.from_numpy(r) for r in ints]
    np.testing.assert_array_equal(TC.psum(parts).numpy(), ints.sum(0))
    np.testing.assert_array_equal(TC.pmin(parts).numpy(), ints.min(0))
    np.testing.assert_array_equal(TC.pmax(parts).numpy(), ints.max(0))


def test_quantized_psum_unit_bound():
    """|result − exact| <= pes · scale (the JAX package's bound), with V
    not a multiple of pes."""
    pes = 4
    x = np.random.default_rng(0).normal(size=(pes, 67)).astype(np.float32)
    out = TC.quantized_psum([torch.from_numpy(r) for r in x]).numpy()
    scale = np.abs(x).max() / 127.0
    assert np.abs(out - x.sum(axis=0)).max() <= pes * scale + 1e-6
    q, s = TC.quantize_messages(torch.from_numpy(x[0]))
    rq, rs = RComm.quantize_messages(jnp.asarray(x[0]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(
        TC.dequantize_messages(q, s).numpy(),
        np.asarray(RComm.dequantize_messages(rq, rs)))


def test_float_min_collective_settles_zero_ties():
    """A +0/-0 tie across PEs settles as -0 < +0, as the kernels' atomics
    settle it within one PE; NaN propagates."""
    a = torch.tensor([0.0, -0.0, 1.0, float("nan")])
    b = torch.tensor([-0.0, 0.0, 2.0, 0.0])
    for parts in ([a, b], [b, a]):
        got = TC.pmin(parts)
        assert torch.signbit(got[:2]).all() and got[2] == 1.0
        assert torch.isnan(got[3])
        assert not torch.signbit(TC.pmax(parts)[:2]).any()


# ---------------------------------------------------------------------------
# 6. batched and sliced lanes, checkpoints, the server
# ---------------------------------------------------------------------------


def _lane_equals_sequential(prog, values, iters, stats, roots):
    for i, r in enumerate(roots):
        v, it = prog.run(roots=int(r))
        assert torch.equal(values[i], v), i
        assert int(iters[i]) == it
        seq = prog.last_run_stats
        for k in set(stats) & set(seq) - {"pes"}:
            assert stats[k][i] == seq[k], (k, i, stats[k][i], seq[k])


@pytest.mark.parametrize("alpha", [1.0, 8.0])
@pytest.mark.parametrize("template", TEMPLATES)
def test_run_batch_multi_pe_matches_sequential(graphs, template, alpha):
    """Each lane of a pes=2 batch equals a sequential pes=2 run (values,
    iters, every counter) and the JAX package's pes=1 run; alpha 8 mixes
    swept and pushed lanes in one batched superstep."""
    rg, tg = graphs
    program = TD.PROGRAM_TEMPLATES[template]()
    prog = TT.translate(program, tg, TS.ScheduleConfig(
        pes=2, direction=TS.DirectionPolicy(alpha=alpha)), device=CPU,
        devices=_cpus(2))
    roots = [0, 7, 31, 7]
    before = prog.lane_pushes
    bv, bi = prog.run_batch(roots)
    stats = prog.last_run_stats
    assert prog.lane_pushes > before
    assert stats["pes"] == 2
    assert np.asarray(stats["push_live_rows_per_pe"]).shape == (4, 2)
    _lane_equals_sequential(prog, bv, bi, stats, roots)
    rprog = RT.translate(RD.PROGRAM_TEMPLATES[template](), rg,
                         RS.ScheduleConfig(direction=RS.DirectionPolicy(
                             alpha=alpha)))
    rv, ri = rprog.run_batch(np.asarray(roots))
    np.testing.assert_array_equal(np.asarray(rv), bv.numpy())
    np.testing.assert_array_equal(np.asarray(ri), bi.numpy())


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_sliced_lanes_concatenate_to_run_batch(graphs, backend):
    _, tg = graphs
    prog = TT.translate(TD.sssp_program(), tg, _cfg(TS, 2, backend=backend),
                        device=CPU, devices=_cpus(2))
    roots = [0, 5, 17]
    bv, bi = prog.run_batch(roots)
    want = prog.last_run_stats
    state = prog.batch_init(roots)
    while not prog.lane_done(state).all():
        state = prog.run_batch_slice(state, 2)
    assert torch.equal(state.values, bv)
    np.testing.assert_array_equal(state.iters, bi.numpy())
    assert prog.lane_stats(state) == want
    # a lane admitted into a sliced batch finishes as its own run
    state = prog.lane_admit(state, 1, 250)
    while not prog.lane_done(state).all():
        state = prog.run_batch_slice(state, 3)
    v, it = prog.run(roots=250)
    assert torch.equal(state.values[1], v) and int(state.iters[1]) == it


def test_exchange_stats_recorded_from_run_loop(graphs, tmp_path):
    """The comm manager accumulates the executed exchanges of each run;
    a batch records its batched supersteps that exchanged and the tables
    they carried, a sliced or checkpointed run what its slices ran."""
    _, tg = graphs
    comm = TC.CommManager()
    prog = TT.translate(TD.bfs_program(TALG.INT_MAX), tg, _cfg(TS, 2), comm,
                        device=CPU, devices=_cpus(2))
    assert comm.stats.collective_bytes_total == 0
    prog.run(roots=0)
    s = prog.last_run_stats
    assert s["exchange_supersteps"] == s["push_compacted_supersteps"] > 0
    assert s["exchange_bytes"] == \
        s["exchange_supersteps"] * prog.report.est_collective_bytes
    assert comm.stats.collective_supersteps == s["exchange_supersteps"]
    assert comm.stats.collective_bytes_total == s["exchange_bytes"]
    prog.run(roots=0)
    rep = comm.report(device=CPU)
    assert rep["collective_bytes_total"] == 2 * s["exchange_bytes"]
    assert rep["collective_supersteps"] == 2 * s["exchange_supersteps"]
    assert TC.CommManager(_cpus(2)).status()["mesh"] == \
        {"shape": {"pe": 2}}
    per = prog.report.est_collective_bytes + prog.report.est_frontier_bytes
    for roots in ([0], [0, 9]):
        steps0 = comm.stats.collective_supersteps
        bytes0 = comm.stats.collective_bytes_total
        prog.run_batch(roots)
        lanes = prog.last_run_stats["exchange_supersteps"]
        steps = comm.stats.collective_supersteps - steps0
        tables, rem = divmod(comm.stats.collective_bytes_total - bytes0, per)
        assert rem == 0 and max(lanes) <= steps <= sum(lanes)
        assert sum(lanes) <= tables <= len(roots) * steps
        if len(roots) == 1:     # one lane: a table a superstep, as run()
            assert steps == tables == s["exchange_supersteps"]
    steps0 = comm.stats.collective_supersteps
    prog.run(roots=0, checkpoint_dir=str(tmp_path))
    assert comm.stats.collective_supersteps - steps0 == \
        s["exchange_supersteps"]


@pytest.mark.chaos
def test_collective_fault_raises_typed(graphs):
    rg, tg = graphs
    want, _ = _jax_pes1(rg, "bfs", backend="sparse")
    prog = TT.translate(TD.bfs_program(), tg, _cfg(TS, 2, backend="sparse"),
                        TC.CommManager(), device=CPU, devices=_cpus(2))
    with faults.injected("comm.collective"):
        with pytest.raises(InjectedFault):
            prog.run(roots=0)
    values, _ = prog.run(roots=0)            # disarmed: runs clean
    np.testing.assert_array_equal(want, values.numpy())


def test_snapshots_cross_packages(graphs, tmp_path):
    """A pes=2 lane snapshot carries pe_rows (k, 2); either package
    restores the other's, the fingerprints agree, and the port finishes
    the restored lanes as its uncut batch; a snapshot of another PE count
    is refused typed."""
    rg, tg = graphs
    roots = np.asarray([0, 9, 17])
    cfg, rcfg = _cfg(TS, 2), _cfg(RS, 2)
    prog = TT.translate(TD.bfs_program(), tg, cfg, device=CPU,
                        devices=_cpus(2))
    want_v, want_i = prog.run_batch(roots)
    want_stats = prog.last_run_stats
    state = prog.run_batch_slice(prog.batch_init(roots), 2)
    snap = prog.lane_snapshot(state)
    assert snap["pe_rows"].shape == (3, 2) and snap["pe_rows"].any()
    fps = ckpt.run_fingerprints(TD.bfs_program(), tg, cfg)
    assert fps == RC.run_fingerprints(RD.bfs_program(), rg, rcfg) | {
        "program": fps["program"]}
    stem = ckpt.write_snapshot(str(tmp_path / "t"), "lane", 0, snap, {}, fps)
    _, arrays = RC.read_snapshot(stem, kind="lane")
    rprog = RT.translate(RD.bfs_program(), rg, rcfg)
    rstate = rprog.lane_restore(arrays)
    back = rprog.lane_snapshot(rstate)
    stem = RC.write_snapshot(str(tmp_path / "r"), "lane", 0, back, {}, {})
    _, arrays = ckpt.read_snapshot(stem, kind="lane")
    for k in snap:
        np.testing.assert_array_equal(snap[k], arrays[k], err_msg=k)
    state = prog.lane_restore(arrays)
    while not prog.lane_done(state).all():
        state = prog.run_batch_slice(state, 3)
    assert torch.equal(state.values, want_v)
    np.testing.assert_array_equal(state.iters, want_i.numpy())
    assert prog.lane_stats(state) == want_stats
    one = TT.translate(TD.bfs_program(), tg, TS.ScheduleConfig(), device=CPU)
    with pytest.raises(CheckpointMismatchError):
        one.lane_restore(arrays)


def test_checkpointed_multi_pe_run_equals_plain(graphs, tmp_path):
    _, tg = graphs
    prog = TT.translate(TD.sssp_program(), tg, _cfg(TS, 2), device=CPU,
                        devices=_cpus(2))
    want, it = prog.run(roots=5)
    stats = dict(prog.last_run_stats)
    got, it2 = prog.run(roots=5, checkpoint_dir=str(tmp_path),
                        checkpoint_every=2)
    assert torch.equal(got, want) and it2 == it
    for k, v in stats.items():
        assert prog.last_run_stats[k] == v, k
    assert prog.last_run_stats["checkpoint_saves"] >= 2


def test_serving_bit_exact_under_multi_pe(graphs):
    """A pes=2 server answers bit for bit as sequential pes=2 runs and the
    JAX package's pes=1 runs."""
    rg, tg = graphs
    cfg = _cfg(TS, 2)
    srv = GraphServer(tg, schedule=cfg, device=CPU, devices=_cpus(2),
                      admission=TS.AdmissionPolicy(slots=2,
                                                   slice_supersteps=2))
    handles = [srv.submit("bfs", 0), srv.submit("sssp", 5),
               srv.submit("bfs", 17), srv.submit("sssp", 250)]
    srv.run()
    for q in handles:
        assert q.done, q.status
        prog = TT.translate(q.program, tg, cfg, device=CPU,
                            devices=_cpus(2))
        assert prog.report.pes == 2
        v, it = prog.run(roots=q.root)
        np.testing.assert_array_equal(np.asarray(q.result), v.numpy())
        assert q.iters == it
        rv, ri = RT.translate(
            RD.PROGRAM_TEMPLATES[q.kind](), rg,
            RS.ScheduleConfig()).run(roots=q.root)
        np.testing.assert_array_equal(np.asarray(q.result), np.asarray(rv))
