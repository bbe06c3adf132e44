"""Port parity: the bitmap plane's lane axis (2L, the lane sweep with a
per-lane early-out) on the CPU.

2L is kernel 2 (``edge_block_reduce(block_live=...)``) under ``jax.vmap``:
both lane kernels (``edge_block_fold_lanes``, ``edge_block_reduce_lanes``)
take a ``(k', nblk)`` flag table.  Its plain version is held, bit for bit,
against k single-lane kernel-2 plain sweeps and their ``subrow_combine``
on random flags (NaN and +0/-0 in the values), against the JAX kernel
under ``vmap`` in interpret mode, and against 1L on flags derived from the
lanes' touched tables (``push_ell.push_lanes_touched``, the lane push's
scan with a one-byte message).  The batched superstep of the bitmap plane
(``run_batch``, ``run_batch_slice``, the lane API, the graph server, a PE
group of 2) equals the JAX package's ``run_batch`` and the port's
sequential runs in values and every ``run_stats`` counter; its route is
one 2L sweep and no single-lane pull step a batched superstep, with one
host read; on the kernel path's structure (CPU tensors, plain versions)
each lane's grid-granular counters equal the single-lane kernel path's.
The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.core import dsl as RD
from repro.core import graph as RG
from repro.core import scheduler as RS
from repro.core import translator as RT
from repro.kernels import edge_block as reb
from repro.kernels import ops as rops
from repro.serve import graph_serve as RGS

import torch
from repro_torch.core import dsl as TD
from repro_torch.core import graph as G
from repro_torch.core import ir as TI
from repro_torch.core import passes as TPS
from repro_torch.core import preprocess as TP
from repro_torch.core import scheduler as TS
from repro_torch.core import translator as TT
from repro_torch.kernels import edge_block as teb
from repro_torch.kernels import pull_bitmap as tpb
from repro_torch.kernels import push_ell as tpe
from repro_torch.kernels import ref as tref
from repro_torch.serve.graph_serve import GraphServer
from torch_threads import one_thread  # noqa: F401

V, E = 300, 3000
ROOTS = np.asarray([0, 5, 5, 17, 250, 299])
TEMPLATES = ("bfs", "sssp", "wcc")
# grid blocks of 4 sub-rows and plan blocks of one (8 slots): narrow tiers
# of 10 and 38 out-edges, and grid blocks that a narrow frontier leaves dead
BITMAP = dict(pull_sweep="bitmap", block_rows=4, pull_block_slots=8)
# pull, push, the default auto, and an auto whose lanes pull narrow
# frontiers and push others in the same batched supersteps
MODES = {"pull": dict(mode="pull"), "push": dict(mode="push"),
         "auto": dict(mode="auto"),
         "auto-mixed": dict(mode="auto", alpha=8.0, beta=100.0)}


@pytest.fixture(scope="module")
def graphs():
    src, dst = RG.rmat_edges(V, E, seed=7)
    w = np.random.default_rng(3).uniform(0.5, 2.0, len(src)) \
        .astype(np.float32)
    return (RG.from_edge_list(src, dst, weights=w, num_vertices=V),
            G.from_edge_list(src, dst, weights=w, num_vertices=V))


def _cfg(mod, mode="pull", **kw):
    return mod.ScheduleConfig(direction=mod.DirectionPolicy(**MODES[mode]),
                              **{**BITMAP, **kw})


def _pair(template, rg, tg, mode, **kw):
    rp = RT.translate(RD.PROGRAM_TEMPLATES[template](), rg,
                      _cfg(RS, mode, **kw))
    tp = TT.translate(TD.PROGRAM_TEMPLATES[template](), tg,
                      _cfg(TS, mode, **kw), device="cpu")
    assert tp.report.pull_sweep == "bitmap"
    return rp, tp


def _bits(t):
    """A table's bit patterns, every NaN as one pattern."""
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    if a.dtype != np.float32:
        return a
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


def _lane_matches_run(tp, values, iters, stats, roots):
    """Each lane equals the port's sequential run, values and counters."""
    for i, r in enumerate(roots):
        v, it = tp.run(roots=int(r))
        assert torch.equal(values[i], v), i
        assert int(iters[i]) == it
        seq = tp.last_run_stats
        for k in set(stats) & set(seq) - {"batch_size", "pes"}:
            assert stats[k][i] == seq[k], (k, i, stats[k][i], seq[k])


class _Spy:
    """Counts the calls of module functions while installed."""

    def __init__(self, monkeypatch, targets):
        self.calls = {name: [] for name, _ in targets}
        for name, (mod, attr) in targets:
            orig = getattr(mod, attr)

            def spy(*a, _orig=orig, _name=name, **kw):
                self.calls[_name].append(kw)
                return _orig(*a, **kw)
            monkeypatch.setattr(mod, attr, spy)


# ---------------------------------------------------------------------------
# 1. 2L's plain version and the touched tables
# ---------------------------------------------------------------------------


def _plan(tg):
    return TP.layouts_for(tg).pull_plan(64)


def _state(rng, kk, dtype, frac=0.4):
    """A (kk, V) state with NaN and zeros of either sign in float lanes."""
    if dtype == np.int32:
        vals = rng.integers(-50, 50, (kk, V)).astype(np.int32)
    else:
        vals = rng.uniform(0, 5, (kk, V)).astype(np.float32)
        zero = rng.random((kk, V)) < 0.33
        vals[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
        vals[1::2] *= -1
        vals[rng.random((kk, V)) < 0.03] = np.nan
    act = rng.random((kk, V)) < frac
    return torch.as_tensor(vals), torch.as_tensor(act)


_FLAG_CASES = [("copy", "min", np.int32), ("plus_one", "min", np.int32),
               ("add_w", "min", np.float32), ("mul_w", "max", np.float32),
               ("copy", "max", np.int32), ("copy", "add", np.int32),
               ("div_deg", "add", np.float32), ("add_w", "add", np.float32)]


@pytest.mark.parametrize("gather,reduce,dtype", _FLAG_CASES)
def test_lane_flags_plain_equals_single_lane_kernel2(graphs, gather, reduce,
                                                     dtype):
    """2L's plain version on random flags (a ragged last grid block)
    equals k single-lane kernel-2 plain sweeps (and, in the fold, their
    ``subrow_combine``) bit for bit: k of 1, 3, 8 and 33 lanes listed out
    of order in a 35-lane state, NaN and +0/-0 values, mask_inactive on
    and off; rows not listed hold the identity."""
    _, tg = graphs
    plan = _plan(tg)
    R = plan.flat_dst.shape[0]
    deg = tg.out_degrees.to(torch.int32)
    tdtype = torch.int32 if dtype == np.int32 else torch.float32
    ident = tref._identity(reduce, tdtype)
    rng = np.random.default_rng(len(gather) * 5 + len(reduce))
    kk, br = 35, 5
    assert R % br
    vals, act = _state(rng, kk, dtype)
    flags = torch.as_tensor(rng.random((kk, -(-R // br))) < 0.5)
    fold = not (reduce == "add" and dtype == np.float32)
    for mask in (True, False):
        kw = dict(gather=gather, reduce=reduce, mask_inactive=mask)
        for k in (1, 3, 8, 33):
            lanes = [int(i) for i in rng.permutation(kk)[:k]]
            singles = [teb.edge_block_reduce(
                plan.flat_dst, plan.flat_wgt, vals[i], deg, act[i],
                block_live=flags[i], block_rows=br, **kw) for i in lanes]
            # the flag table itself (the plain version's reference input)
            # and its words (what the wrapper takes) give the same sweep
            table = dict(block_live=flags, block_rows=br)
            words = dict(block_words=teb.block_words_from_flags(
                flags, lanes, br))
            if not fold:
                for red, anys in (
                        teb.edge_block_reduce_lanes_plain(
                            plan.flat_dst, plan.flat_wgt, vals, deg, act,
                            lanes, **table, **kw),
                        teb.edge_block_reduce_lanes(
                            plan.flat_dst, plan.flat_wgt, vals, deg, act,
                            lanes, **words, **kw)):
                    for j, (s_red, s_any) in enumerate(singles):
                        np.testing.assert_array_equal(_bits(red[j]),
                                                      _bits(s_red))
                        assert torch.equal(anys[j], s_any)
                continue
            for red, got in (
                    teb.edge_block_fold_lanes_plain(plan, vals, deg, act,
                                                    lanes, **table, **kw),
                    teb.edge_block_fold_lanes(plan, vals, deg, act, lanes,
                                              **words, **kw)):
                for i, (s_red, s_any) in zip(lanes, singles):
                    want = tpb.subrow_combine(s_red, plan, ident, reduce,
                                              tdtype)
                    want_got = tpb.subrow_combine(
                        s_any.to(torch.int8), plan, 0, "max",
                        torch.int8) != 0
                    np.testing.assert_array_equal(_bits(red[i]),
                                                  _bits(want))
                    assert torch.equal(got[i], want_got)
                left_out = [i for i in range(kk) if i not in lanes]
                assert bool((red[left_out] == ident).all())
                assert not bool(got[left_out].any())


@pytest.mark.parametrize("reduce,dtype", [("min", np.int32),
                                          ("max", np.float32),
                                          ("add", np.float32)])
def test_lane_flags_match_jax_kernel2_under_vmap(graphs, reduce, dtype):
    """The sub-row partials of 2L's plain version equal the JAX early-out
    kernel (``_kernel_skip``, interpret mode) under ``jax.vmap`` over the
    lanes and their flags, in value (JAX leaves the sign of a tied zero
    to its order)."""
    _, tg = graphs
    plan = _plan(tg)
    R = plan.flat_dst.shape[0]
    deg = tg.out_degrees.to(torch.int32)
    rng = np.random.default_rng(11)
    kk, br = 6, 8
    vals, act = _state(rng, kk, dtype)
    nb = -(-R // br)
    flags = torch.as_tensor(rng.random((kk, nb)) < 0.5)
    kw = dict(gather="add_w" if dtype == np.float32 else "plus_one",
              reduce=reduce, mask_inactive=True)

    def one(v, a, f):
        return reb.edge_block_reduce(
            jnp.asarray(plan.flat_dst.numpy()),
            jnp.asarray(plan.flat_wgt.numpy()), v, jnp.asarray(deg.numpy()),
            a, block_rows=br, block_live=f, **kw)

    r_red, r_any = jax.jit(jax.vmap(one))(
        jnp.asarray(vals.numpy()), jnp.asarray(act.numpy()),
        jnp.asarray(flags.numpy()))
    red, anys = teb.edge_block_reduce_lanes_plain(
        plan.flat_dst, plan.flat_wgt, vals, deg, act, block_live=flags,
        block_rows=br, **kw)
    np.testing.assert_array_equal(np.asarray(r_red), red.numpy())
    np.testing.assert_array_equal(np.asarray(r_any), anys.numpy())
    assert (~flags).any() and flags.any()


def test_touched_flags_lane_sweep_equals_1l(graphs):
    """On flags from the lanes' touched tables (the bitmap plane's), 2L
    equals 1L bit for bit, and the touched tables equal each lane's
    single-lane ``touched_table`` and the JAX ``touched_frontier``."""
    _, tg = graphs
    lay = TP.layouts_for(tg)
    plan, fe = _plan(tg), lay.forward_ell(8)
    deg = tg.out_degrees.to(torch.int32)
    rng = np.random.default_rng(5)
    kk = 9
    vals, _ = _state(rng, kk, np.float32)
    act = torch.zeros((kk, V), dtype=torch.bool)
    for i in range(kk):             # frontiers of 1 .. 9 vertices
        act[i, torch.as_tensor(rng.choice(V, i + 1, replace=False))] = True
    lanes = [7, 0, 3, 8, 1]
    touched = tpe.push_lanes_touched(fe.row_src, fe.dst, act, lanes,
                                     num_rows=fe.num_rows)
    for i in range(kk):
        if i not in lanes:
            assert not touched[i].any()
            continue
        want = tpb.touched_table(fe.row_src, fe.dst, act[i],
                                 num_rows=fe.num_rows, capacity=fe.num_rows,
                                 num_vertices=V)
        assert torch.equal(touched[i], want[:V] != 0)
        ref = rops.touched_frontier(
            jnp.asarray(fe.row_src.numpy()), jnp.asarray(fe.dst.numpy()),
            jnp.asarray(act[i].numpy()), num_rows=fe.num_rows,
            capacity=fe.num_rows, num_vertices=V)
        np.testing.assert_array_equal(np.asarray(ref)[:V] != 0,
                                      touched[i].numpy())
    table = torch.cat([touched, touched.new_zeros((kk, 1))], 1)
    for br in (4, 5, 128):
        flags = tpb.grid_block_live(touched, plan.owner8, br)
        # a (k, V+1) table with its dummy slot, or 1, 8 or 9 lanes of it
        assert torch.equal(flags, tpb.grid_block_live(table, plan.owner8,
                                                      br))
        for rows in ([3], lanes[:3] + [2, 4, 5, 6, 8], list(range(kk))):
            assert torch.equal(flags[rows], tpb.grid_block_live(
                touched[rows], plan.owner8, br))
        for i in lanes:
            assert torch.equal(flags[i], tpb.grid_block_live(
                table[i], plan.owner8, br))
        assert not flags[lanes].all()
        words = teb.block_words_from_flags(flags, lanes, br)
        for reduce in ("min", "max"):
            kw = dict(gather="add_w", reduce=reduce)
            skip = teb.edge_block_fold_lanes(plan, vals, deg, act, lanes,
                                             block_words=words, **kw)
            full = teb.edge_block_fold_lanes(plan, vals, deg, act, lanes,
                                             **kw)
            for a, b in zip(skip, full):
                np.testing.assert_array_equal(_bits(a), _bits(b))
        kw = dict(gather="mul_w", reduce="add", need_any=True)
        skip = teb.edge_block_reduce_lanes(
            plan.flat_dst, plan.flat_wgt, vals, deg, act, lanes,
            block_words=words, **kw)
        full = teb.edge_block_reduce_lanes(plan.flat_dst, plan.flat_wgt,
                                           vals, deg, act, lanes, **kw)
        for a, b in zip(skip, full):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_lane_flag_wrappers_on_cpu(graphs):
    """Flags of the wrong shape, dtype or grid raise: a flag table in the
    plain versions, its words in the wrappers (words of other lanes or
    another grid); on CPU tensors no launch is counted."""
    _, tg = graphs
    plan = _plan(tg)
    R = plan.flat_dst.shape[0]
    deg = tg.out_degrees.to(torch.int32)
    vals, act = _state(np.random.default_rng(1), 4, np.int32)
    kw = dict(gather="copy", reduce="min")
    good = torch.ones((4, -(-R // 4)), dtype=torch.bool)
    for bad, rows in ((good[:3], 4), (good.float(), 4), (good, 3),
                      (good, None), (good[:, ::2], 8)):
        with pytest.raises(ValueError, match="block_live"):
            teb.edge_block_fold_lanes_plain(plan, vals, deg, act, [0, 2],
                                            block_live=bad, block_rows=rows,
                                            **kw)
        with pytest.raises(ValueError, match="block_live"):
            teb.edge_block_reduce_lanes_plain(
                plan.flat_dst, plan.flat_wgt, vals, deg, act, [1],
                block_live=bad, block_rows=rows, **kw)
    for lanes, rows in (([0, 2], 8), ([2, 0], 4), ([1], 4)):
        bad = teb.block_words_from_flags(
            torch.ones((4, -(-R // rows)), dtype=torch.bool), lanes, rows)
        if rows == 8:                # the words of another grid
            bad = bad._replace(block_rows=4)
        with pytest.raises(ValueError, match="block_words"):
            teb.edge_block_fold_lanes(plan, vals, deg, act, [0, 2],
                                      block_words=bad, **kw)
        if lanes != [1]:
            with pytest.raises(ValueError, match="block_words"):
                teb.edge_block_reduce_lanes(plan.flat_dst, plan.flat_wgt,
                                            vals, deg, act, [1],
                                            block_words=bad, **kw)
    with pytest.raises(ValueError, match="distinct rows"):
        tpe.push_lanes_touched(plan.flat_dst[:, 0], plan.flat_dst, act,
                               [1, 1], num_rows=1)
    for fn, count in ((teb.edge_block_fold_lanes, "skip_launches"),
                      (teb.edge_block_reduce_lanes, "skip_launches"),
                      (tpe.push_lanes_touched, "launches")):
        assert getattr(fn, count) == 0              # no card here


# ---------------------------------------------------------------------------
# 2. the batched superstep against the JAX package and sequential runs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("template", TEMPLATES)
def test_run_batch_matches_jax_and_sequential(graphs, template, mode):
    """``run_batch`` on the bitmap plane: values, ``iters`` and every
    ``run_stats`` counter (``pull_blocks_swept``/``_skipped`` included)
    equal the JAX package's ``run_batch`` and each lane the port's
    sequential run."""
    rg, tg = graphs
    rp, tp = _pair(template, rg, tg, mode)
    rv, ri = rp.run_batch(ROOTS)
    tv, ti = tp.run_batch(ROOTS)
    np.testing.assert_array_equal(np.asarray(rv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ri), ti.numpy())
    stats = tp.last_run_stats
    assert rp.last_run_stats == stats
    _lane_matches_run(tp, tv, ti, stats, ROOTS)
    if mode in ("pull", "auto-mixed"):
        assert sum(stats["pull_blocks_skipped"]) > 0


@pytest.mark.parametrize("mode", ["pull", "auto-mixed"])
def test_sliced_runs_match_jax(graphs, mode):
    """Uneven slices of the bitmap plane's batched supersteps: the state
    after each slice, and its lane_stats, equal the JAX package's."""
    rg, tg = graphs
    rp, tp = _pair("sssp", rg, tg, mode)
    roots = np.asarray([0, 5, 17, 299])
    rs, ts = rp.batch_init(roots), tp.batch_init(roots)
    for budget in (1, 2, 3, 1, 50):
        rs = rp.run_batch_slice(rs, budget)
        ts = tp.run_batch_slice(ts, budget)
        np.testing.assert_array_equal(np.asarray(rs.values),
                                      ts.values.numpy())
        for f in TT.BatchLaneState._fields[2:]:
            np.testing.assert_array_equal(np.asarray(getattr(rs, f)),
                                          getattr(ts, f), err_msg=f)
        assert rp.lane_stats(rs) == tp.lane_stats(ts)
    assert tp.lane_done(ts).all()


def test_lane_api_matches_sequential(graphs):
    """Admits into an idle state mid-flight, slices, harvests: every lane
    ends as its sequential run, counters included."""
    _, tg = graphs
    tp = TT.translate(TD.bfs_program(), tg, _cfg(TS, "auto-mixed"),
                      device="cpu")
    state = tp.batch_idle(3)
    queue = [0, 17, 5, 250, 42, 299]
    done = {}
    lane_root = {}
    while queue or lane_root:
        for lane in range(3):
            if lane not in lane_root and queue:
                lane_root[lane] = queue.pop(0)
                state = tp.lane_admit(state, lane, lane_root[lane])
        state = tp.run_batch_slice(state, 2)
        stats = tp.lane_stats(state)
        for lane in np.flatnonzero(tp.lane_done(state)):
            if lane in lane_root:
                done[lane_root.pop(lane)] = (
                    state.values[lane].clone(), int(state.iters[lane]),
                    {k: v[lane] for k, v in stats.items()
                     if isinstance(v, list)})
    for root, (v, it, st) in done.items():
        want, want_it = tp.run(roots=root)
        assert torch.equal(v, want) and it == want_it
        seq = tp.last_run_stats
        for k in set(st) & set(seq):
            assert st[k] == seq[k], (root, k)


_FLOAT_PROGRAMS = {
    # a weighted float sum whose apply fixes the identity (no touched mask)
    "facc": dict(gather=lambda v, w, d: v * w, reduce="add",
                 apply=lambda old, s: old + s),
    # one whose apply moves untouched vertices: the touched mask is got
    "fdecay": dict(gather=lambda v, w, d: v * w, reduce="add",
                   apply=lambda old, s: 0.5 * old + s),
}


@pytest.mark.parametrize("name", list(_FLOAT_PROGRAMS))
def test_float_add_lanes_on_bitmap_plane(graphs, name):
    """A float add on the bitmap plane (2L's sub-row partials, then each
    lane's ``subrow_combine``): bit for bit the port's sequential runs and
    within rtol 1e-5 of the JAX package's ``run_batch``; ppr (frontier
    'all', so the dense plane under the same schedule) likewise."""
    rg, tg = graphs
    kw = _FLOAT_PROGRAMS[name]
    rprog = RD.VertexProgram(name=name, init_value=1.0, frontier="changed",
                             value_dtype=jnp.float32, max_iters=6, **kw)
    tprog = TD.VertexProgram(name=name, init_value=1.0, frontier="changed",
                             value_dtype=torch.float32, max_iters=6, **kw)
    roots = np.asarray([0, 5, 250])
    for r_prog, t_prog, sweep in ((rprog, tprog, "bitmap"),
                                  (RD.ppr_program(250), TD.ppr_program(250),
                                   "dense")):
        rp = RT.translate(r_prog, rg, _cfg(RS))
        tp = TT.translate(t_prog, tg, _cfg(TS), device="cpu")
        assert tp.report.pull_sweep == sweep
        rv, ri = rp.run_batch(roots)
        tv, ti = tp.run_batch(roots)
        np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_array_equal(np.asarray(ri), ti.numpy())
        _lane_matches_run(tp, tv, ti, tp.last_run_stats, roots)


@pytest.mark.parametrize("template", ["bfs", "sssp", "wcc"])
def test_lanes_on_a_pe_group_of_two(graphs, template):
    """pes=2 on a CPU device list (the push plane sharded, the bitmap pull
    plane replicated): each lane equals the port's sequential pes=2 run in
    every counter, and the JAX package's pes=1 ``run_batch`` in values,
    ``iters`` and every counter that does not count PEs."""
    rg, tg = graphs
    rp = RT.translate(RD.PROGRAM_TEMPLATES[template](), rg,
                      _cfg(RS, "auto-mixed"))
    tp = TT.translate(TD.PROGRAM_TEMPLATES[template](), tg,
                      _cfg(TS, "auto-mixed", pes=2), device="cpu",
                      devices=["cpu"] * 2)
    assert tp.report.pes == 2 and tp.report.exchange_plane == "push"
    rv, ri = rp.run_batch(ROOTS)
    tv, ti = tp.run_batch(ROOTS)
    np.testing.assert_array_equal(np.asarray(rv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ri), ti.numpy())
    stats = tp.last_run_stats
    per_pe = {"pes", "push_live_rows_per_pe", "exchange_supersteps",
              "exchange_bytes"}
    for k in set(stats) - per_pe:
        assert rp.last_run_stats[k] == stats[k], k
    _lane_matches_run(tp, tv, ti, stats, ROOTS)


# ---------------------------------------------------------------------------
# 3. the route: one 2L sweep and one read a batched superstep
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("template", TEMPLATES)
def test_batched_superstep_route(graphs, template, monkeypatch):
    """Each batched superstep with narrow pull lanes runs one touched pass,
    one flags pass and one 2L sweep, no single-lane pull step, and one
    host read; the lanes in the wide tier share that sweep, all blocks
    live."""
    _, tg = graphs
    tp = TT.translate(TD.PROGRAM_TEMPLATES[template](), tg,
                      _cfg(TS, "auto-mixed"), device="cpu")
    spy = _Spy(monkeypatch, [
        ("fold", (teb, "edge_block_fold_lanes")),
        ("touched", (tpe, "push_lanes_touched")),
        ("words", (teb, "lane_block_words")),
        ("push", (tpe, "push_ell_lanes_reduce"))])
    singles = []
    pull_step = tp._pull_step
    tp._pull_step = lambda *a: singles.append(1) or pull_step(*a)
    state = tp.batch_init(ROOTS)
    narrow = 0
    caps = tp.report.pull_block_tiers
    while not tp.lane_done(state).all():
        for calls in spy.calls.values():
            calls.clear()
        reads = tp.lane_reads
        occ = tp._lane_occupancy(state)
        before = tp.lane_reads
        state = tp.run_batch_slice(state, 1)
        assert tp.lane_reads - before == 1
        assert reads == before                 # the last read remembered
        stepped = state.iters != 0
        pulls = [i for i in range(len(ROOTS))
                 if stepped[i] and state.direction[i] == 0
                 and occ.n_f[i] > 0]
        skips = [c for c in spy.calls["fold"]
                 if c.get("block_words") is not None]
        n_narrow = sum(occ.m_f[i] <= caps[1] for i in pulls)
        if n_narrow:
            narrow += 1
            assert len(spy.calls["touched"]) == 1
            assert len(spy.calls["words"]) == 1
            assert len(skips) == 1 and len(spy.calls["fold"]) == 1
            flags = teb.block_words_flags(skips[0]["block_words"],
                                          len(ROOTS))
            for i in pulls:
                if occ.m_f[i] > caps[1]:
                    assert bool(flags[i].all())
        else:
            assert not spy.calls["touched"] and not skips
            assert not spy.calls["words"]
        assert len(spy.calls["fold"]) <= 1 and len(spy.calls["push"]) <= 1
    assert narrow > 0
    assert not singles


def test_graph_server_on_bitmap_plane(graphs):
    """``GraphServer`` with ``pull_sweep='bitmap'``: every answer equals a
    sequential run's, and the JAX server's on the same stream (ppr within
    rtol 1e-5); its batched supersteps launch no single-lane pull step."""
    rg, tg = graphs
    stream = [("bfs", 0), ("sssp", 5), ("ppr", 7), ("bfs", 17),
              ("sssp", 5), ("bfs", 0), ("sssp", 250), ("bfs", 299),
              ("ppr", 7), ("bfs", 42)]
    cfg = _cfg(TS, "auto-mixed")
    srv = GraphServer(tg, schedule=cfg, device="cpu",
                      admission=TS.AdmissionPolicy(slots=3,
                                                   slice_supersteps=2))
    handles = [srv.submit(k, r) for k, r in stream]
    srv.run()
    ref = RGS.GraphServer(rg, schedule=_cfg(RS, "auto-mixed"),
                          admission=RS.AdmissionPolicy(slots=3,
                                                       slice_supersteps=2))
    ref_handles = [ref.submit(k, r) for k, r in stream]
    ref.run()
    for a, q in zip(ref_handles, handles):
        assert q.done, q.status
        prog = TT.translate(q.program, tg, cfg, device="cpu")
        want, it = prog.run(roots=q.root)
        np.testing.assert_array_equal(q.result, want.numpy())
        assert q.iters == it
        assert (a.served_by, a.iters, a.qid) == (q.served_by, q.iters, q.qid)
        if q.kind == "ppr":
            np.testing.assert_allclose(q.result, np.asarray(a.result),
                                       rtol=1e-5, atol=1e-7)
        else:
            assert prog.report.pull_sweep == "bitmap"
            np.testing.assert_array_equal(q.result, np.asarray(a.result))
        assert a.stats == q.stats, q.kind
    c = srv.counters()
    assert c["host_reads"] == c["batched_supersteps"] + c["harvests"]
    assert c["masked_sweeps"] > 0


# ---------------------------------------------------------------------------
# 4. the kernel path's counters, on CPU tensors
# ---------------------------------------------------------------------------


def _kernel_structure(tg, template, grid_rows, slots):
    """The bitmap plane's single-lane superstep and batched superstep with
    the kernel path's structure, on CPU tensors (every kernel wrapper takes
    its plain version)."""
    cfg = _cfg(TS, block_rows=grid_rows, pull_block_slots=slots)
    ctx = TPS.PassContext(schedule=cfg,
                          plan=TS.plan(cfg, num_vertices=V, num_edges=E),
                          use_kernels=True, num_vertices=V, num_edges=E)
    ir, _ = TPS.default_pipeline().run(
        TI.lower_program(TD.PROGRAM_TEMPLATES[template]()), ctx)
    fstep = ir.find(TI.FusedSuperstepOp)
    assert fstep.pull_sweep == "bitmap"
    lay = TP.layouts_for(tg)
    pplan, fe = lay.pull_plan(cfg.pull_block_slots), lay.forward_ell(8)
    out_deg = tg.out_degrees.to(torch.int32)
    reduce_module, sub_sweep = TT._emit_dense_pull_reduce(
        ir, fstep.fused, pplan, out_deg, True)
    step, caps = TT._emit_pull_bitmap(ir, fstep, pplan, fe, out_deg,
                                      reduce_module, sub_sweep, True, E, cfg)
    lane_step, _ = TT._emit_lane_step(
        ir, fstep.fused, pplan, out_deg, sub_sweep, fstep.apply.fn,
        fstep.frontier, fstep.touched_free, True, None, None, E,
        (fe, grid_rows))
    return step, lane_step, caps, out_deg, pplan


@pytest.mark.parametrize("grid_rows,slots", [(4, 8), (4, 16), (5, 16)])
@pytest.mark.parametrize("template", ["bfs", "wcc"])
def test_kernel_path_counters_match_single_lane(graphs, template, grid_rows,
                                                slots):
    """With the kernel path's structure each lane of one batched
    superstep (narrow and wide pull lanes together, one lane of the state
    left out) equals the single-lane kernel path's superstep: values,
    frontier and its grid-granular counters, on grids that hold whole plan
    blocks (4 sub-rows over blocks of 1 and 2) and on an odd one (5 over
    blocks of 2, counted at the plan's blocks)."""
    _, tg = graphs
    step, lane_step, caps, out_deg, pplan = _kernel_structure(
        tg, template, grid_rows, slots)
    assert (grid_rows % pplan.block_rows != 0) == (grid_rows == 5)
    rng = np.random.default_rng(grid_rows + slots)
    kk = 8
    values = torch.as_tensor(rng.integers(0, 20, (kk, V)).astype(np.int32))
    active = torch.zeros((kk, V), dtype=torch.bool)
    deg = out_deg.numpy()
    small = np.flatnonzero((deg > 0) & (deg <= 3))
    for i in range(kk - 2):           # narrow frontiers of 1 .. 6 vertices
        active[i, torch.as_tensor(rng.choice(small, i + 1,
                                             replace=False))] = True
    active[kk - 2] = torch.as_tensor(rng.random(V) < 0.5)    # wide
    active[kk - 1] = True
    m_f = [int(x) for x in torch.where(active, out_deg, 0).sum(1)]
    assert min(m_f) <= caps[0] < caps[1] < max(m_f)
    lanes = [3, 0, 7, 5, 1, 6, 2]          # lane 4 is left out
    new, nxt, pending = lane_step(values, active, lanes, [True] * 7, [],
                                  [m_f[i] for i in lanes])
    skipped = 0
    for i in range(kk):
        if i not in lanes:
            assert torch.equal(new[i], values[i])
            assert torch.equal(nxt[i], active[i])
            assert i not in pending
            continue
        s_new, s_nxt, s_cnt = step(values[i], active[i], m_f[i])
        assert torch.equal(new[i], s_new) and torch.equal(nxt[i], s_nxt)
        assert [int(x) for x in pending[i]] == [int(x) for x in s_cnt], i
        skipped += int(s_cnt[2])
    assert skipped > 0
