"""Port parity: the block-skipping bitmap pull plane against the JAX
package on the CPU.

The same numpy inputs, made from a seed, go through both packages.  The
layout helpers are equal element for element; one bitmap pull superstep
is exact in ``new``, ``next_active`` and its three sweep counters, on the
plain path (against the JAX package's XLA path, ``use_pallas=False``) and
on the kernel path driven with CPU tensors, where the early-out kernel
takes its plain version (against the Pallas path in interpret mode, whose
skip counters round up to grid blocks); whole bfs/sssp/wcc runs are
bit-exact in values, ``iters`` and every ``run_stats`` field.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.core import algorithms as RALG
from repro.core import dsl as RD
from repro.core import graph as RG
from repro.core import preprocess as RP
from repro.core import scheduler as RS
from repro.core import translator as RT
from repro.kernels import ops as rops
from repro.kernels import pull_bitmap as rpb

import torch
from repro_torch.core import algorithms as TALG
from repro_torch.core import dsl as TD
from repro_torch.core import graph as G
from repro_torch.core import ir as TI
from repro_torch.core import passes as TPS
from repro_torch.core import preprocess as TP
from repro_torch.core import scheduler as TS
from repro_torch.core import translator as TT
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pull_bitmap as tpb
from torch_stats import jax_stats
from torch_threads import one_thread  # noqa: F401

V, E = 1500, 12000
INT_MAX = 2**30


@pytest.fixture(scope="module")
def graphs():
    src, dst = RG.rmat_edges(V, E, seed=0)
    w = np.random.default_rng(7).uniform(0.5, 4.0, len(src)) \
        .astype(np.float32)
    return (RG.from_edge_list(src, dst, num_vertices=V, weights=w),
            G.from_edge_list(src, dst, num_vertices=V, weights=w), src, dst)


def _eq(ref, port):
    a = np.asarray(ref)
    b = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _frontiers(src, dst, rng):
    """Frontiers that drive every branch of the bitmap superstep: narrow
    tiers with few or many lit blocks (R-MAT hubs' in-neighbors light a
    dozen blocks per edge, overflowing the gathered path's 4·cap block
    buffer), the dense tail, and the empty and full frontiers."""
    indeg = np.bincount(dst, minlength=V)
    outdeg = np.bincount(src, minlength=V)
    hubs = np.argsort(indeg)[::-1]
    leaves = [np.unique(src[(dst == h) & (outdeg[src] == 1)])
              for h in hubs[:12]]
    out = [np.zeros(V, bool), np.ones(V, bool)]
    for k, per_hub in ((1, 1), (2, 1), (5, 1), (12, 1), (12, 2)):
        f = np.zeros(V, bool)
        for lv in leaves[:k]:
            f[lv[:per_hub]] = True
        out.append(f)
    small = np.nonzero((outdeg > 0) & (outdeg <= 2))[0]
    for n in (1, 4, 9):
        f = np.zeros(V, bool)
        f[rng.choice(small, n, replace=False)] = True
        out.append(f)
    for frac in (0.05, 0.3):
        out.append(rng.random(V) < frac)
    return out


def _bfs_cfg(mod, sweep="bitmap", direction="pull", **kw):
    return mod.ScheduleConfig(direction=mod.DirectionPolicy(mode=direction),
                              pull_sweep=sweep, **kw)


def _port_kernel_structure(tg):
    """The port's bitmap superstep with the kernel path's structure, on
    CPU tensors (the early-out kernel takes its plain version)."""
    cfg = _bfs_cfg(TS)
    ctx = TPS.PassContext(schedule=cfg,
                          plan=TS.plan(cfg, num_vertices=V, num_edges=E),
                          use_kernels=True, num_vertices=V, num_edges=E)
    ir, _ = TPS.default_pipeline().run(
        TI.lower_program(TD.bfs_program(INT_MAX)), ctx)
    fstep = ir.find(TI.FusedSuperstepOp)
    assert fstep.pull_sweep == "bitmap" and ir.backend == "dense_cuda"
    lay = TP.layouts_for(tg)
    pplan, fe = lay.pull_plan(cfg.pull_block_slots), lay.forward_ell(8)
    out_deg = tg.out_degrees.to(torch.int32)
    reduce_module, sub_sweep = TT._emit_dense_pull_reduce(
        ir, fstep.fused, pplan, out_deg, True)
    step, _ = TT._emit_pull_bitmap(ir, fstep, pplan, fe, out_deg,
                                   reduce_module, sub_sweep, True, E, cfg)
    return step, pplan


# ---------------------------------------------------------------------------
# layouts and plane helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,frac", [(1, 1.0), (33, 0.5), (1000, 0.1),
                                    (64, 0.0)])
def test_unpack_bits_matches(n, frac):
    mask = np.random.default_rng(n).random(n) < frac
    words = G.pack_bits(torch.as_tensor(mask))
    _eq(np.asarray(RG.pack_bits(jnp.asarray(mask))).astype(np.int64), words)
    _eq(RG.unpack_bits(RG.pack_bits(jnp.asarray(mask)), n),
        G.unpack_bits(words, n))


def test_coo_arrays_and_reverse_coo_match(graphs):
    rg, tg, _, _ = graphs
    for r, t in zip(RG.coo_arrays(rg), G.coo_arrays(tg)):
        _eq(r, t)
    for r, t in zip(RP.layouts_for(rg).reverse_coo(),
                    TP.layouts_for(tg).reverse_coo()):
        _eq(r, t)
    edgeless = G.from_edge_list(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                num_vertices=4)
    assert G.coo_arrays(edgeless)[0].shape == (0,)


@pytest.mark.parametrize("frac", [0.0, 0.01, 0.2, 1.0])
def test_touched_liveness_and_word_range_match(graphs, frac):
    rg, tg, _, _ = graphs
    rfe, tfe = RG.forward_ell(rg, width=8), G.forward_ell(tg, width=8)
    rp = RP.layouts_for(rg).pull_plan(64)
    tp = TP.layouts_for(tg).pull_plan(64)
    act = np.random.default_rng(3).random(V) < frac
    cap = int(np.asarray(tfe.rows_per_vertex)[act].sum()) + 1
    rt = rops.touched_frontier(rfe.row_src, rfe.dst, jnp.asarray(act),
                               num_rows=rfe.num_rows, capacity=cap,
                               num_vertices=V)
    tt = tops.touched_frontier(tfe.row_src, tfe.dst, torch.as_tensor(act),
                               num_rows=tfe.num_rows, capacity=cap,
                               num_vertices=V)
    _eq(rt, tt)
    live = tpb.block_liveness(tt, tp.owner8, tp.block_rows)
    _eq(rpb.block_liveness(rt, rp.owner8, rp.block_rows), live)
    rwp = rpb.word_prefix(RG.pack_bits(rt[:V] != 0))
    twp = tpb.word_prefix(G.pack_bits(tt[:V] != 0))
    _eq(rwp, twp)
    rng_live = tpb.block_range_live(twp, tp.block_word_lo, tp.block_word_hi)
    _eq(rpb.block_range_live(rwp, rp.block_word_lo, rp.block_word_hi),
        rng_live)
    assert bool((rng_live | ~live).all())       # the range form is conservative


# ---------------------------------------------------------------------------
# one superstep: every branch, both paths
# ---------------------------------------------------------------------------


def test_bitmap_superstep_plain_path_matches_xla(graphs):
    rg, tg, src, dst = graphs
    ref = RT.translate(RD.bfs_program(INT_MAX), rg, _bfs_cfg(RS),
                       use_pallas=False)
    port = TT.translate(TD.bfs_program(INT_MAX), tg, _bfs_cfg(TS),
                        device="cpu")
    caps = port.report.pull_block_tiers
    nb = port.report.pull_blocks_total
    assert caps == ref.report.pull_block_tiers
    rng = np.random.default_rng(0)
    values = rng.integers(0, 10, V).astype(np.int32)
    deg = np.bincount(src, minlength=V)
    seen = set()
    for f in _frontiers(src, dst, rng):
        rn, rx, rs = ref._superstep(jnp.asarray(values), jnp.asarray(f))
        tn, tx, ts = port._pull_step(torch.as_tensor(values),
                                     torch.as_tensor(f))
        _eq(rn, tn)
        _eq(rx, tx)
        assert [int(x) for x in rs] == [int(x) for x in ts]
        m_f = int(deg[f].sum())
        tier = int(m_f > caps[0]) + int(m_f > caps[1])
        overflow = tier < 2 and int(ts[1]) == nb and int(ts[0]) == E
        seen.add((tier, overflow))
    # both narrow tiers compacted, the overflow guard, the dense tail
    assert {(0, False), (1, False), (2, False)} <= seen
    assert (0, True) in seen or (1, True) in seen


def test_bitmap_superstep_kernel_path_matches_pallas(graphs):
    rg, tg, src, dst = graphs
    ref = RT.translate(RD.bfs_program(INT_MAX), rg, _bfs_cfg(RS),
                       use_pallas=True)
    step, pplan = _port_kernel_structure(tg)
    rng = np.random.default_rng(1)
    values = rng.integers(0, 10, V).astype(np.int32)
    skipped = 0
    for f in _frontiers(src, dst, rng):
        rn, rx, rs = ref._superstep(jnp.asarray(values), jnp.asarray(f))
        tn, tx, ts = step(torch.as_tensor(values), torch.as_tensor(f))
        _eq(rn, tn)
        _eq(rx, tx)
        assert [int(x) for x in rs] == [int(x) for x in ts]
        skipped += int(ts[2])
    assert skipped > 0
    # the grid-rounded counters still close over the plan's blocks
    assert int(ts[1]) + int(ts[2]) == pplan.num_blocks


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------


def _run_pair(rg, tg, algo, direction, sweep="bitmap"):
    rcfg, tcfg = _bfs_cfg(RS, sweep, direction), _bfs_cfg(TS, sweep,
                                                          direction)
    rprog = {"bfs": RD.bfs_program(INT_MAX), "sssp": RD.sssp_program(),
             "wcc": RD.wcc_program()}[algo]
    tprog = {"bfs": TD.bfs_program(INT_MAX), "sssp": TD.sssp_program(),
             "wcc": TD.wcc_program()}[algo]
    roots = None if algo == "wcc" else 3
    r = RT.translate(rprog, rg, rcfg, use_pallas=False)
    t = TT.translate(tprog, tg, tcfg, device="cpu")
    rv, ri = r.run(roots=roots)
    tv, ti = t.run(roots=roots)
    return (rv, int(ri), r.last_run_stats, r.report), \
        (tv, ti, jax_stats(t.last_run_stats), t.report)


@pytest.mark.parametrize("algo", ["bfs", "sssp", "wcc"])
@pytest.mark.parametrize("direction", ["pull", "push", "auto"])
def test_bitmap_runs_bit_exact(graphs, algo, direction):
    rg, tg, _, _ = graphs
    (rv, ri, rs, rrep), (tv, ti, ts, trep) = _run_pair(rg, tg, algo,
                                                       direction)
    _eq(rv, tv)
    assert ri == ti
    assert rs == ts
    assert trep.pull_sweep == rrep.pull_sweep == "bitmap"
    assert trep.pull_block_tiers == rrep.pull_block_tiers
    assert trep.pull_blocks_total == rrep.pull_blocks_total


def _narrow_tail_graph(src, dst):
    """The fixture's R-MAT plus a BFS tail from root 3 that stays narrow:
    five levels of vertex pairs hung off the second-last level, then a
    chain of ten single vertices."""
    g0 = G.from_edge_list(src, dst, num_vertices=V)
    lv = TALG.bfs(g0, 3, device="cpu")[0].numpy()
    last = lv[lv < INT_MAX].max()
    prev = [int(np.nonzero(lv == last - 1)[0][0])]
    nxt, extra = iter(range(V, V + 20)), []
    for width in [2] * 5 + [1] * 10:
        level = [next(nxt) for _ in range(width)]
        extra += [(a, b) for a in prev for b in level]
        prev = level
    s2 = np.concatenate([src, [a for a, _ in extra]]).astype(np.int32)
    d2 = np.concatenate([dst, [b for _, b in extra]]).astype(np.int32)
    return (RG.from_edge_list(s2, d2, num_vertices=V + 20),
            G.from_edge_list(s2, d2, num_vertices=V + 20))


def test_measured_pull_cost_changes_auto_direction(graphs):
    """The bitmap plane's measured pull cost (the last pull superstep's
    swept edges, not E) moves the auto policy's push→pull choice: on a
    narrow BFS tail the run's directions differ from the dense plane's,
    in both packages alike, and the values do not."""
    _, _, src, dst = graphs
    rg, tg = _narrow_tail_graph(src, dst)
    outs = {}
    for sweep in ("dense", "bitmap"):
        cfgs = [mod.ScheduleConfig(
            backend="dense", pull_sweep=sweep, direction=mod.DirectionPolicy(
                mode="auto", alpha=16.0, beta=1000.0)) for mod in (RS, TS)]
        r = RT.translate(RD.bfs_program(INT_MAX), rg, cfgs[0],
                         use_pallas=False)
        t = TT.translate(TD.bfs_program(INT_MAX), tg, cfgs[1], device="cpu")
        rv, ri = r.run(roots=3)
        tv, ti = t.run(roots=3)
        _eq(rv, tv)
        assert int(ri) == ti and \
            r.last_run_stats == jax_stats(t.last_run_stats)
        outs[sweep] = (tv, t.last_run_stats)
    _eq(outs["dense"][0], outs["bitmap"][0])
    dense, bitmap = outs["dense"][1], outs["bitmap"][1]
    assert bitmap["pull_cost_model"] < dense["pull_cost_model"] == \
        tg.num_edges
    assert bitmap["direction_switches"] > dense["direction_switches"]
    assert bitmap["push_supersteps"] != dense["push_supersteps"]


def test_float_add_program_rides_bitmap_plane(graphs):
    """Block skipping needs no commutativity: a float-add masked program
    takes the bitmap plane (push stays pinned) and equals the dense
    plane and the JAX package bit for bit."""
    rg, tg, _, _ = graphs
    rprog = RD.VertexProgram(
        name="facc", gather=lambda v, w, d: v * w, reduce="add",
        apply=lambda old, s: old + s, init_value=1.0, frontier="changed",
        value_dtype=jnp.float32, max_iters=6)
    tprog = TD.VertexProgram(
        name="facc", gather=lambda v, w, d: v * w, reduce="add",
        apply=lambda old, s: old + s, init_value=1.0, frontier="changed",
        value_dtype=torch.float32, max_iters=6)
    outs = []
    for sweep in ("dense", "bitmap"):
        r = RT.translate(rprog, rg, _bfs_cfg(RS, sweep), use_pallas=False)
        t = TT.translate(tprog, tg, _bfs_cfg(TS, sweep), device="cpu")
        assert t.report.pull_sweep == sweep
        assert t.report.directions == ("pull",)
        rv, _ = r.run(roots=0)
        tv, _ = t.run(roots=0)
        _eq(rv, tv)
        assert r.last_run_stats == jax_stats(t.last_run_stats)
        outs.append(tv)
    assert torch.equal(outs[0], outs[1])


def test_bitmap_run_syncs_once_per_superstep(graphs):
    _, tg, _, _ = graphs
    t = TT.translate(TD.bfs_program(INT_MAX), tg, _bfs_cfg(TS), device="cpu")
    _, it = t.run(roots=3)
    assert t.last_run_syncs == it + 1
    s = t.last_run_stats
    assert s["pull_blocks_swept"] + s["pull_blocks_skipped"] == \
        t.report.pull_blocks_total * s["pull_supersteps"]
    assert s["pull_blocks_skipped"] > 0


@pytest.mark.parametrize("k", [2, 4])
def test_k_core_matches(graphs, k):
    rg, tg, _, _ = graphs
    rmask, rit = RALG.k_core(rg, k)
    tmask, tit = TALG.k_core(tg, k, device="cpu")
    _eq(rmask, tmask)
    assert rit == tit
    assert 0 < tmask.sum() < V
