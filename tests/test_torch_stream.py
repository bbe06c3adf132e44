"""Port parity: out-of-core streaming (partition store, containers, the
streamed engine), on the CPU.

Case for case with ``tests/test_partition.py``: the same numpy inputs go
through the JAX package's streamed engine and the port's
(``repro_torch.core.stream``, its kernels' plain versions on the CPU).
bfs / sssp / wcc are bit-exact against the JAX streamed run in values,
iterations and every ``run_stats`` counter (partition sweeps, skips and
bytes shipped included) at 1-5 partitions x pull / push / auto; pagerank
within ``rtol=1e-5`` (the partials combine in ascending partition order,
the reassociation the JAX package documents) and bitwise deterministic.
The port's store pads a partition's slots with the kernels' ``PAD``
(2**31 - 1) where the JAX package's pads with ``V``; the layout test maps
one onto the other.  Containers written by either package load in the
other.
"""
import os

import numpy as np
import pytest

import repro.core  # noqa: F401  (import order: core before kernels)
from repro.core import dsl as RD
from repro.core import graph as RG
from repro.core import preprocess as RP
from repro.core import scheduler as RS
from repro.core.comm import CommManager as RComm
from repro.core.translator import translate as rtranslate
from repro.data import graphs as RDATA
from repro.serve.graph_serve import GraphServer as RServer

import torch
from repro_torch.core import dsl
from repro_torch.core import graph as G
from repro_torch.core import preprocess
from repro_torch.core.comm import CommManager
from repro_torch.core.scheduler import (DirectionPolicy, ScheduleConfig,
                                        estimate_stream_bytes, plan)
from repro_torch.core.stream import PartitionedGraphProgram
from repro_torch.core.translator import translate
from repro_torch.data import graphs as D
from repro_torch.serve.graph_serve import GraphServer

CPU = "cpu"
# run_stats keys that are measured times, not counters
_TIMES = ("partition_transfer_s", "partition_compute_s", "partition_wall_s",
          "overlap_efficiency", "checkpoint_write_s")


@pytest.fixture(scope="module")
def graphs():
    src, dst = RG.rmat_edges(2000, 16000, seed=7)
    return (RG.from_edge_list(src, dst, num_vertices=2000),
            G.from_edge_list(src, dst, num_vertices=2000))


@pytest.fixture(scope="module")
def wgraphs():
    rng = np.random.default_rng(3)
    src, dst = RG.rmat_edges(600, 5000, seed=11)
    w = rng.uniform(0.5, 2.0, size=src.shape[0]).astype(np.float32)
    return (RG.from_edge_list(src, dst, weights=w, num_vertices=600),
            G.from_edge_list(src, dst, weights=w, num_vertices=600))


def _rcfg(parts, mode="pull", budget=None):
    return RS.ScheduleConfig(partitions=parts, partition_budget_bytes=budget,
                             direction=RS.DirectionPolicy(mode=mode))


def _tcfg(parts, mode="pull", budget=None):
    return ScheduleConfig(partitions=parts, partition_budget_bytes=budget,
                          direction=DirectionPolicy(mode=mode))


def _counters(stats: dict) -> dict:
    """A run's stats without the measured times and the store's build
    seconds: what must be equal across the packages."""
    out = {k: v for k, v in stats.items() if k not in _TIMES}
    if "partition_store" in out:
        out["partition_store"] = {k: v for k, v in
                                  out["partition_store"].items()
                                  if k != "build_s"}
    return out


def _same(a, b):
    a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _sources(rg, tg, parts, tmp_path):
    """Both packages' sources of a streamed run over ``parts`` partitions:
    the graphs and a plan axis, or (one partition) a container each."""
    if parts > 1:
        return rg, tg
    rpath = RDATA.container_from_graph(str(tmp_path / "r.npz"), rg, 1)
    tpath = D.container_from_graph(str(tmp_path / "t.npz"), tg, 1)
    return (RDATA.load_partition_container(rpath),
            D.load_partition_container(tpath))


def _both(rprog_fn, tprog_fn, rsrc, tsrc, parts, mode, root):
    rp = rtranslate(rprog_fn(), rsrc, _rcfg(parts, mode))
    tp = translate(tprog_fn(), tsrc, _tcfg(parts, mode), device=CPU)
    assert isinstance(tp, PartitionedGraphProgram)
    assert tp.report.num_partitions == rp.report.num_partitions == parts
    rv, rit = rp.run(roots=root)
    tv, tit = tp.run(roots=root)
    return rp, tp, (rv, rit), (tv, tit)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def test_edge_interval_cuts_invariants():
    deg = np.array([5, 0, 3, 7, 1, 0, 2, 4], np.int64)
    for parts in (1, 2, 3, 8, 20):
        cuts = G.edge_interval_cuts(deg, parts)
        assert cuts[0] == 0 and cuts[-1] == len(deg)
        assert len(cuts) == parts + 1
        assert (np.diff(cuts) >= 0).all()
        np.testing.assert_array_equal(cuts, RG.edge_interval_cuts(deg, parts))
    with pytest.raises(ValueError):
        G.edge_interval_cuts(deg, 0)


def test_edge_interval_cuts_balance():
    rng = np.random.default_rng(0)
    deg = rng.integers(0, 40, size=5000).astype(np.int64)
    cuts = G.edge_interval_cuts(deg, 8)
    np.testing.assert_array_equal(cuts, RG.edge_interval_cuts(deg, 8))
    cum = np.concatenate([[0], np.cumsum(deg)])
    per_part = cum[cuts[1:]] - cum[cuts[:-1]]
    assert per_part.sum() == deg.sum()
    assert per_part.max() <= deg.sum() / 8 + deg.max()


@pytest.mark.parametrize("cut_list", [
    [0, 199], [0, 32, 64, 199], [0, 17, 33, 100, 150, 199],
    [0, 0, 199, 199], [0, 199, 199]])
def test_interval_live_counts_matches_numpy(cut_list):
    import jax.numpy as jnp
    bits = np.random.default_rng(0).integers(0, 2, 199).astype(bool)
    words = G.pack_bits(torch.as_tensor(bits))
    got = G.interval_live_counts(words, torch.as_tensor(cut_list))
    exp = np.array([bits[a:b].sum()
                    for a, b in zip(cut_list[:-1], cut_list[1:])])
    np.testing.assert_array_equal(got.numpy(), exp)
    ref = RG.interval_live_counts(RG.pack_bits(jnp.asarray(bits)),
                                  jnp.asarray(cut_list, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # a batch of frontiers, one row each
    rows = np.stack([bits, ~bits])
    batch = G.interval_live_counts(G.pack_bits(torch.as_tensor(rows)),
                                   torch.as_tensor(cut_list))
    np.testing.assert_array_equal(batch[0].numpy(), exp)
    np.testing.assert_array_equal(
        batch[1].numpy(), np.diff(cut_list) - exp)


def test_partition_coo_union_is_full_edge_set(graphs):
    rg, g = graphs
    cuts = G.edge_interval_cuts(g.out_degrees.numpy(), 5)
    srcs, dsts = [], []
    for p in range(5):
        s, d, w = G.partition_coo(g, int(cuts[p]), int(cuts[p + 1]))
        rs, rd, rw = RG.partition_coo(rg, int(cuts[p]), int(cuts[p + 1]))
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(d, rd)
        np.testing.assert_array_equal(w, np.asarray(rw))
        if len(s):
            assert s.min() >= cuts[p] and s.max() < cuts[p + 1]
        srcs.append(s)
        dsts.append(d)
    g2 = G.from_edge_list(np.concatenate(srcs), np.concatenate(dsts),
                          num_vertices=g.num_vertices, sort=False)
    _same(g.edge_offsets, g2.edge_offsets)
    _same(g.edges_dst, g2.edges_dst)


# ---------------------------------------------------------------------------
# plan: the partition axis
# ---------------------------------------------------------------------------


def test_plan_budget_resolves_partition_count():
    total = estimate_stream_bytes(16000)
    assert total == RS.estimate_stream_bytes(16000)
    for cfg, want in ((dict(partition_budget_bytes=total // 4 + 1), 4),
                      (dict(partitions=8,
                            partition_budget_bytes=total // 4 + 1), 8)):
        sp = plan(ScheduleConfig(**cfg), num_vertices=2000,
                  num_edges=16000)
        rsp = RS.plan(RS.ScheduleConfig(**cfg), num_vertices=2000,
                      num_edges=16000)
        assert sp.num_partitions == rsp.num_partitions == want
        assert sp.partition_budget_bytes == rsp.partition_budget_bytes
        assert sp.describe() == rsp.describe()
    assert "partitions=8" in sp.describe()


def test_plan_partitions_single_pe_only():
    for mod in (RS, None):
        with pytest.raises(ValueError, match="single-PE"):
            (mod.plan if mod else plan)(
                (mod.ScheduleConfig if mod else ScheduleConfig)(
                    partitions=2, pes=2),
                num_vertices=2000, num_edges=16000)


def test_plan_fixed_partitions_pins_count():
    sp = plan(ScheduleConfig(partitions=2), num_vertices=100,
              num_edges=1000, fixed_partitions=6)
    rsp = RS.plan(RS.ScheduleConfig(partitions=2), num_vertices=100,
                  num_edges=1000, fixed_partitions=6)
    assert sp.num_partitions == rsp.num_partitions == 6


# ---------------------------------------------------------------------------
# differential: the port's streamed engine against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parts", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("mode", ["pull", "push", "auto"])
def test_bfs_partitioned_bitexact(graphs, parts, mode, tmp_path):
    rg, tg = graphs
    rsrc, tsrc = _sources(rg, tg, parts, tmp_path)
    rp, tp, (rv, rit), (tv, tit) = _both(RD.bfs_program, dsl.bfs_program,
                                         rsrc, tsrc, parts, mode, 0)
    _same(rv, tv)
    assert int(rit) == tit
    assert _counters(rp.last_run_stats) == _counters(tp.last_run_stats)
    ref, it_ref = translate(dsl.bfs_program(), tg, device=CPU).run(roots=0)
    _same(ref, tv)
    assert it_ref == tit
    # one device→host read a superstep
    assert tp.lane_reads == tit


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("mode", ["pull", "push", "auto"])
def test_sssp_partitioned_bitexact(wgraphs, parts, mode):
    rg, tg = wgraphs
    rp, tp, (rv, rit), (tv, tit) = _both(RD.sssp_program, dsl.sssp_program,
                                         rg, tg, parts, mode, 0)
    _same(rv, tv)
    assert int(rit) == tit
    assert _counters(rp.last_run_stats) == _counters(tp.last_run_stats)
    ref, _ = translate(dsl.sssp_program(), tg, device=CPU).run(roots=0)
    _same(ref, tv)


@pytest.mark.parametrize("mode", ["pull", "push", "auto"])
def test_wcc_partitioned_bitexact(graphs, mode):
    rg, tg = graphs
    rp, tp, (rv, rit), (tv, tit) = _both(RD.wcc_program, dsl.wcc_program,
                                         rg, tg, 3, mode, None)
    _same(rv, tv)
    assert int(rit) == tit
    assert _counters(rp.last_run_stats) == _counters(tp.last_run_stats)
    ref, _ = translate(dsl.wcc_program(), tg, device=CPU).run()
    _same(ref, tv)


def test_pagerank_partitioned_allclose(graphs):
    rg, tg = graphs
    rp, tp, (rv, rit), (tv, tit) = _both(RD.pagerank_program,
                                         dsl.pagerank_program, rg, tg, 4,
                                         "pull", None)
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=1e-5,
                               atol=1e-7)
    assert int(rit) == tit
    assert _counters(rp.last_run_stats) == _counters(tp.last_run_stats)
    ref, _ = translate(dsl.pagerank_program(), tg, device=CPU).run()
    np.testing.assert_allclose(tv.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-7)
    # deterministic across repeats, and across translates
    tv2, _ = tp.run()
    tv3, _ = translate(dsl.pagerank_program(), tg, _tcfg(4),
                       device=CPU).run()
    _same(tv, tv2)
    _same(tv, tv3)


def test_degree_streams_through_a_message_table(graphs):
    """A weight-free gather outside the menu (degree's) streams: its
    message table is computed a superstep and gathered with 'copy'."""
    rg, tg = graphs
    rp, tp, (rv, _), (tv, _) = _both(RD.degree_program, dsl.degree_program,
                                     rg, tg, 3, "pull", None)
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=1e-6)


def _general_programs(pkg, np_mod):
    """Weighted gathers outside the menu: ``v + 2 * w`` under min and
    ``v * w + 1`` under add, in either package's DSL."""
    inf = float("inf")
    return {
        "min": pkg.VertexProgram(
            name="two_w", gather=lambda v, w, d: v + 2 * w, reduce="min",
            apply=np_mod.minimum, init_value=inf, frontier="changed",
            value_dtype=np_mod.float32),
        "add": pkg.VertexProgram(
            name="affine_w", gather=lambda v, w, d: v * w + 1, reduce="add",
            apply=lambda old, s: 0.5 * s, init_value=1.0, frontier="all",
            value_dtype=np_mod.float32, mask_inactive=False, max_iters=5),
    }


@pytest.mark.parametrize("reduce", ["min", "add"])
@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("mode", ["pull", "push", "auto"])
def test_weighted_general_gather_streams(wgraphs, reduce, parts, mode):
    """A weighted gather outside the menu streams through the general
    partial (the user's gather in PyTorch, folded by owner through kernel
    4's plain version on the pull plane, scattered on the push plane):
    min bit-exact and add within rtol 1e-5 of the JAX streamed engine,
    every counter equal, bytes shipped included; and equal to the port's
    resident run."""
    import jax.numpy as jnp
    rg, tg = wgraphs
    rprog = _general_programs(RD, jnp)[reduce]
    tprog = _general_programs(dsl, torch)[reduce]
    root = 0 if reduce == "min" else None
    rp, tp, (rv, rit), (tv, tit) = _both(lambda: rprog, lambda: tprog,
                                         rg, tg, parts, mode, root)
    assert tp._general and tp.report.gather_module is None
    assert int(rit) == tit
    assert _counters(rp.last_run_stats) == _counters(tp.last_run_stats)
    assert tp.last_run_stats["partition_bytes_h2d"] > 0
    ref, _ = translate(tprog, tg, device=CPU).run(roots=root)
    if reduce == "min":
        _same(rv, tv)
        _same(ref, tv)
    else:
        np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=1e-5)
        np.testing.assert_allclose(tv.numpy(), ref.numpy(), rtol=1e-5)


def test_other_dtypes_stream_through_the_general_partial(wgraphs):
    """Values outside the lane kernels' int32/float32 stream too (the
    general partial), equal to the resident run of the same dtype."""
    _, tg = wgraphs
    prog = dsl.VertexProgram(
        name="sssp64", gather=lambda v, w, d: v + w, reduce="min",
        apply=torch.minimum, init_value=float("inf"), frontier="changed",
        value_dtype=torch.float64)
    for mode in ("pull", "push"):
        tp = translate(prog, tg, _tcfg(3, mode), device=CPU)
        assert tp._general
        tv, tit = tp.run(roots=0)
        ref, rit = translate(prog, tg, device=CPU).run(roots=0)
        assert tv.dtype == torch.float64 and tit == rit
        _same(ref, tv)


def test_partitions_skipped_on_late_supersteps(graphs):
    rg, tg = graphs
    rp, tp, _, _ = _both(RD.bfs_program, dsl.bfs_program, rg, tg, 5,
                         "pull", 0)
    st = tp.last_run_stats
    assert st["partitions_skipped"] >= 1
    assert st["partitions_swept"] + st["partitions_skipped"] == \
        st["partitions"] * (st["pull_supersteps"] + st["push_supersteps"])
    assert st["partition_bytes_h2d"] > 0
    assert st["partition_store"]["partitions"] == 5
    for k in ("partitions_skipped", "partitions_swept",
              "partition_bytes_h2d", "partitions_transferred"):
        assert st[k] == rp.last_run_stats[k], k


def test_partitioned_run_batch_matches_sequential(graphs):
    rg, tg = graphs
    roots = [0, 5, 17, 123]
    rp = rtranslate(RD.bfs_program(), rg, _rcfg(3))
    tp = translate(dsl.bfs_program(), tg, _tcfg(3), device=CPU)
    rvb, rib = rp.run_batch(roots)
    reads0 = tp.lane_reads
    vb, ib = tp.run_batch(roots)
    _same(rvb, vb)
    np.testing.assert_array_equal(np.asarray(rib), ib.numpy())
    assert _counters(rp.last_run_stats) == _counters(tp.last_run_stats)
    assert tp.lane_reads - reads0 == int(ib.max())
    cp = translate(dsl.bfs_program(), tg, device=CPU)
    for i, r in enumerate(roots):
        ref, it = cp.run(roots=r)
        assert int(ib[i]) == it
        _same(ref, vb[i])


def test_run_batch_slices_match_full_run(graphs):
    rg, tg = graphs
    roots = [0, 5, 17]
    tp = translate(dsl.bfs_program(), tg, _tcfg(3), device=CPU)
    full_v, full_i = tp.run_batch(roots)
    state = tp.batch_init(roots)
    while not tp.lane_done(state).all():
        state = tp.run_batch_slice(state, 2)
    _same(full_v, state.values)
    np.testing.assert_array_equal(full_i.numpy(), state.iters)
    rp = rtranslate(RD.bfs_program(), rg, _rcfg(3))
    rstate = rp.batch_init(roots)
    while not rp.lane_done(rstate).all():
        rstate = rp.run_batch_slice(rstate, 2)
    _same(rstate.values, state.values)
    for name in state._fields[2:]:
        np.testing.assert_array_equal(getattr(rstate, name),
                                      getattr(state, name), err_msg=name)


def test_lane_converges_mid_stream_harvests_correctly(graphs):
    _, tg = graphs
    cp = translate(dsl.bfs_program(), tg, device=CPU)
    pp = translate(dsl.bfs_program(), tg, _tcfg(4), device=CPU)
    deg = tg.out_degrees.numpy()
    slow_root = int(np.nonzero(deg > 0)[0][-1])
    state = pp.batch_idle(2)
    state = pp.lane_admit(state, 0, 0)
    state = pp.lane_admit(state, 1, slow_root)
    harvested = {}
    for _ in range(pp.max_iters):
        state = pp.run_batch_slice(state, 1)
        done = pp.lane_done(state)
        for lane in np.nonzero(done)[0]:
            if int(lane) not in harvested:
                harvested[int(lane)] = pp.lane_values(state, [lane])[0]
        if done.all():
            break
    for lane, root in ((0, 0), (1, slow_root)):
        ref, _ = cp.run(roots=root)
        np.testing.assert_array_equal(ref.numpy(), harvested[lane])


# ---------------------------------------------------------------------------
# PartitionStore + layout-cache budgets
# ---------------------------------------------------------------------------


def test_partition_store_budget_evicts_lru(graphs):
    rg, g = graphs
    cuts = G.edge_interval_cuts(g.out_degrees.numpy(), 6)
    store = preprocess.PartitionStore(g, cuts, max_bytes=1)
    rstore = RP.PartitionStore(rg, cuts, max_bytes=1)
    for p in range(6):
        store.pull_arrays(p)
        rstore.pull_arrays(p)
    st = store.stats()
    assert st["evictions"] >= 3
    assert len(store._cache) == 2
    store.pull_arrays(5)
    rstore.pull_arrays(5)
    assert store.stats()["hits"] == 1
    assert _counters({"partition_store": store.stats()}) == \
        _counters({"partition_store": rstore.stats()})
    unbounded = preprocess.PartitionStore(g, cuts)
    for p in range(6):
        unbounded.pull_arrays(p)
        unbounded.push_arrays(p)
    assert unbounded.stats()["evictions"] == 0
    assert unbounded.stats()["resident_bytes"] == \
        6 * (unbounded._entry_bytes["pull"] + unbounded._entry_bytes["push"])


def test_partition_store_layouts_cover_edges(graphs):
    """The port's layouts equal the JAX package's element for element,
    its slots' PAD standing for the JAX package's pad V; each covers
    every edge once, and the real rows of a partition come first."""
    rg, g = graphs
    V = g.num_vertices
    cuts = G.edge_interval_cuts(g.out_degrees.numpy(), 3)
    store = preprocess.PartitionStore(g, cuts)
    rstore = RP.PartitionStore(rg, cuts)
    assert (store.push_rows_max, store.pull_rows_max) == \
        (rstore.push_rows_max, rstore.pull_rows_max)
    total_push = total_pull = 0
    for p in range(3):
        for plane in ("push", "pull"):
            mine = store._get(p, plane)
            ref = rstore._get(p, plane)
            rows = store.rows_per_partition[plane][p]
            slot = mine["slot"].numpy()
            assert slot.shape == (store.pull_rows_max if plane == "pull"
                                  else store.push_rows_max, store.width)
            np.testing.assert_array_equal(
                np.where(slot == G.PAD, V, slot), ref["slot"])
            np.testing.assert_array_equal(mine["key"].numpy(), ref["key"])
            np.testing.assert_array_equal(mine["wgt"].numpy(), ref["wgt"])
            assert (mine["key"].numpy()[rows:] == V).all()
            assert (mine["key"].numpy()[:rows] < V).all()
        total_push += int((store.push_arrays(p)["slot"] < V).sum())
        total_pull += int((store.pull_arrays(p)["slot"] < V).sum())
    assert total_push == g.num_edges
    assert total_pull == g.num_edges


def test_layout_cache_byte_budget():
    preprocess.layout_cache_clear()
    try:
        preprocess.set_layout_cache_limit(1)   # evict all but the newest
        for seed in range(3):
            src, dst = G.rmat_edges(200, 1500, seed=seed)
            gg = G.from_edge_list(src, dst, num_vertices=200)
            lay = preprocess.layouts_for(gg)
            lay.reverse()                      # grow the entry past 1 byte
            assert lay.nbytes() > 0
            assert "reverse" in lay.stats()["build_times_s"]
        info = preprocess.layout_cache_info()
        assert info["evictions"] >= 2
        assert info["size"] == 1
        assert info["max_bytes"] == 1
        with pytest.raises(ValueError):
            preprocess.set_layout_cache_limit(-1)
    finally:
        preprocess.set_layout_cache_limit(None)
        preprocess.layout_cache_clear()


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------


def test_container_roundtrip_from_graph(tmp_path, graphs):
    """A container either package writes loads in the other, to the same
    graph and metadata."""
    rg, g = graphs
    mine = D.container_from_graph(str(tmp_path / "t.npz"), g, 4)
    theirs = RDATA.container_from_graph(str(tmp_path / "r.npz"), rg, 4)
    for path in (mine, theirs):
        c, rc = D.load_partition_container(path), \
            RDATA.load_partition_container(path)
        assert (c.num_vertices, c.num_edges, c.partitions) == \
            (rc.num_vertices, rc.num_edges, rc.partitions) == \
            (g.num_vertices, g.num_edges, 4)
        np.testing.assert_array_equal(c.checksums, rc.checksums)
        np.testing.assert_array_equal(c.pull_rows, rc.pull_rows)
        g2 = c.to_graph()
        _same(g.edge_offsets, g2.edge_offsets)
        _same(g.edges_dst, g2.edges_dst)
        _same(g.edge_weights, g2.edge_weights)
    # the two files' members are equal
    a, b = np.load(mine), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_chunked_builder_matches_single_shot(tmp_path):
    path = D.build_partition_container(str(tmp_path / "r.npz"), 300, 5000,
                                       partitions=4, seed=1, chunk_edges=700)
    c = D.load_partition_container(path)
    srcs, dsts = zip(*D.rmat_edge_chunks(300, 5000, seed=1, chunk_edges=700))
    ref = G.from_edge_list(np.concatenate(srcs), np.concatenate(dsts),
                           num_vertices=300)
    got = c.to_graph()
    _same(ref.edge_offsets, got.edge_offsets)
    _same(ref.edges_dst, got.edges_dst)
    rpath = RDATA.build_partition_container(
        str(tmp_path / "j.npz"), 300, 5000, partitions=4, seed=1,
        chunk_edges=700)
    a, b = np.load(path), np.load(rpath)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_container_run_matches_resident(tmp_path, graphs):
    rg, tg = graphs
    path = D.container_from_graph(str(tmp_path / "c.npz"), tg, 4)
    c = D.load_partition_container(path)
    rc = RDATA.load_partition_container(path)    # the JAX package reads it
    ref, it_ref = translate(dsl.bfs_program(), tg, device=CPU).run(roots=0)
    pc = translate(dsl.bfs_program(), c, ScheduleConfig(), device=CPU)
    assert isinstance(pc, PartitionedGraphProgram)
    assert pc.report.num_partitions == 4
    v, it = pc.run(roots=0)
    assert it == it_ref
    _same(ref, v)
    rpc = rtranslate(RD.bfs_program(), rc, RS.ScheduleConfig())
    rv, rit = rpc.run(roots=0)
    _same(rv, v)
    assert _counters(rpc.last_run_stats) == _counters(pc.last_run_stats)
    # under a byte budget smaller than the streamed layouts, still exact
    pc2 = translate(dsl.bfs_program(), c,
                    ScheduleConfig(partition_budget_bytes=200_000),
                    device=CPU)
    v2, _ = pc2.run(roots=0)
    _same(ref, v2)
    assert pc2.last_run_stats["partition_store"]["max_bytes"] == 200_000
    rpc2 = rtranslate(RD.bfs_program(), rc,
                      RS.ScheduleConfig(partition_budget_bytes=200_000))
    rpc2.run(roots=0)
    assert _counters(rpc2.last_run_stats) == _counters(pc2.last_run_stats)


def test_container_cli(tmp_path, capsys):
    out = str(tmp_path / "cli.npz")
    D.main([out, "100", "800", "3", "2"])
    assert os.path.exists(out)
    assert "partitions=3" in capsys.readouterr().out
    c = D.load_partition_container(out)
    assert c.num_edges == 800 and c.seed == 2
    rc = RDATA.load_partition_container(out)
    np.testing.assert_array_equal(c.to_graph().edges_dst.numpy(),
                                  np.asarray(rc.to_graph().edges_dst))
    with pytest.raises(SystemExit):
        D.main([out, "100"])


# ---------------------------------------------------------------------------
# serving over a partitioned graph
# ---------------------------------------------------------------------------


def test_serving_partitioned_bitexact_vs_resident_oracle(graphs):
    rg, tg = graphs
    roots = [0, 5, 17, 123, 250]
    srv = GraphServer(tg, schedule=_tcfg(3), device=CPU)
    queries = [srv.submit("bfs", root=r) for r in roots]
    srv.run()
    rsrv = RServer(rg, schedule=_rcfg(3))
    rqueries = [rsrv.submit("bfs", root=r) for r in roots]
    rsrv.run()
    cp = translate(dsl.bfs_program(), tg, device=CPU)
    for q, rq, r in zip(queries, rqueries, roots):
        assert q.status == "done"
        ref, _ = cp.run(roots=r)
        np.testing.assert_array_equal(ref.numpy(), np.asarray(q.result))
        np.testing.assert_array_equal(np.asarray(rq.result),
                                      np.asarray(q.result))
        assert q.iters == rq.iters


def test_serving_partitioned_comm_accounts_transfers(graphs):
    rg, tg = graphs
    comm = CommManager()
    srv = GraphServer(tg, schedule=_tcfg(3), comm=comm, device=CPU)
    srv.submit("bfs", root=0)
    srv.run()
    rcomm = RComm()
    rsrv = RServer(rg, schedule=_rcfg(3), comm=rcomm)
    rsrv.submit("bfs", root=0)
    rsrv.run()
    assert comm.stats.partition_bytes_h2d > 0
    assert comm.stats.partitions_transferred > 0
    assert comm.stats.partition_bytes_h2d == rcomm.stats.partition_bytes_h2d
    assert comm.stats.partitions_transferred == \
        rcomm.stats.partitions_transferred
    rep = comm.report(device=CPU)
    assert "overlap_efficiency" in rep
    assert 0.0 <= rep["overlap_efficiency"] <= 1.0
