"""Port parity: batched lanes (``run_batch`` and the lane API) and the
lane-axis kernel's decomposition, on the CPU.

bfs, sssp and wcc under pull, push and auto, on the dense, bitmap and
sparse planes: each lane's values, ``iters`` and per-lane ``run_stats``
equal the JAX package's ``run_batch`` (and its sliced runs) bit for bit,
and the port's own sequential ``run(roots=r)``.  The float-add templates
(ppr, pagerank) agree with the JAX package within ``rtol=1e-5`` and with
the port's sequential run bitwise.  The lane-axis CUDA kernel runs only
on the card (``chip_smoke.py`` holds it there against kernel 1 and its
plain version); here its decomposition is held against the plain
version: the vertex-major ``(V, K)`` message table and K-bit frontier
words its pre-pass builds, read slot by slot through the flat view.
"""
import numpy as np
import pytest

import repro.core  # noqa: F401  (import order: core before kernels)
from repro.core import dsl as RD
from repro.core import graph as RG
from repro.core import scheduler as RS
from repro.core import translator as RT

import torch
from repro_torch.core import analysis as TA
from repro_torch.core import dsl as TD
from repro_torch.core import graph as G
from repro_torch.core import scheduler as TS
from repro_torch.core import translator as TT
from repro_torch.kernels import edge_block as teb
from repro_torch.kernels import pull_bitmap as tpb
from repro_torch.kernels import ref as tref

PAD = 2**31 - 1
TEMPLATES = {"bfs": ("bfs_program", ()), "sssp": ("sssp_program", ()),
             "wcc": ("wcc_program", ())}
ROOTS = np.asarray([0, 5, 5, 17, 250, 299])


@pytest.fixture(scope="module")
def graphs():
    src, dst = RG.rmat_edges(300, 3000, seed=7)
    w = np.random.default_rng(3).uniform(0.5, 2.0, len(src)) \
        .astype(np.float32)
    return (RG.from_edge_list(src, dst, weights=w, num_vertices=300),
            G.from_edge_list(src, dst, weights=w, num_vertices=300))


def _pair(template, rg, tg, mode="auto", **kw):
    name, args = TEMPLATES[template]
    rp = RT.translate(getattr(RD, name)(*args), rg, RS.ScheduleConfig(
        direction=RS.DirectionPolicy(mode=mode), **kw))
    tp = TT.translate(getattr(TD, name)(*args), tg, TS.ScheduleConfig(
        direction=TS.DirectionPolicy(mode=mode), **kw), device="cpu")
    return rp, tp


def _same_stats(ref: dict, port: dict):
    assert set(ref) == set(port)
    for k in ref:
        assert ref[k] == port[k], (k, ref[k], port[k])


def _lane_matches_run(tp, values, iters, stats, roots):
    """Each lane equals the port's sequential run, values and counters."""
    for i, r in enumerate(roots):
        v, it = tp.run(roots=int(r))
        assert torch.equal(values[i], v), i
        assert int(iters[i]) == it
        seq = tp.last_run_stats
        for k in ("push_supersteps", "push_compacted_supersteps",
                  "push_fallback_supersteps", "pull_supersteps",
                  "direction_switches", "edges_traversed",
                  "pull_blocks_swept", "pull_blocks_skipped",
                  "terminated"):
            assert stats[k][i] == seq[k], (k, i)


_PLANES = [(t, m, {}) for t in TEMPLATES for m in ("pull", "push", "auto")] \
    + [(t, "auto", {"pull_sweep": "bitmap"}) for t in TEMPLATES] \
    + [(t, "auto", {"backend": "sparse"}) for t in TEMPLATES]


@pytest.mark.parametrize("template,mode,kw", _PLANES,
                         ids=[f"{t}-{m}-{'-'.join(kw.values()) or 'dense'}"
                              for t, m, kw in _PLANES])
def test_run_batch_matches_jax_and_sequential(graphs, template, mode, kw):
    rg, tg = graphs
    rp, tp = _pair(template, rg, tg, mode, **kw)
    rv, ri = rp.run_batch(ROOTS)
    tv, ti = tp.run_batch(ROOTS)
    np.testing.assert_array_equal(np.asarray(rv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ri), ti.numpy())
    stats = tp.last_run_stats
    _same_stats(rp.last_run_stats, stats)
    assert stats["batch_size"] == len(ROOTS)
    _lane_matches_run(tp, tv, ti, stats, ROOTS)


@pytest.mark.parametrize("mode", ["pull", "push", "auto"])
def test_sliced_runs_match_jax(graphs, mode):
    """Uneven slices step through the supersteps one run_batch takes: the
    port's state after each slice, and its lane_stats, equal the JAX
    package's after the same slices."""
    rg, tg = graphs
    rp, tp = _pair("sssp", rg, tg, mode)
    roots = np.asarray([0, 5, 5, 17])
    rs, ts = rp.batch_init(roots), tp.batch_init(roots)
    for budget in (1, 2, 3, 1, 50):
        rs = rp.run_batch_slice(rs, budget)
        ts = tp.run_batch_slice(ts, budget)
        np.testing.assert_array_equal(np.asarray(rs.values),
                                      ts.values.numpy())
        for f in TT.BatchLaneState._fields[2:]:
            np.testing.assert_array_equal(np.asarray(getattr(rs, f)),
                                          getattr(ts, f), err_msg=f)
        np.testing.assert_array_equal(rp.lane_done(rs), tp.lane_done(ts))
        _same_stats(rp.lane_stats(rs), tp.lane_stats(ts))
    assert tp.lane_done(ts).all()
    ref_vals, ref_iters = tp.run_batch(roots)
    assert torch.equal(ts.values, ref_vals)
    np.testing.assert_array_equal(ts.iters, ref_iters.numpy())


def test_lane_state_fields_and_dtypes_match_jax(graphs):
    rg, tg = graphs
    rp, tp = _pair("bfs", rg, tg)
    rs = rp.run_batch_slice(rp.batch_init(ROOTS), 2)
    ts = tp.run_batch_slice(tp.batch_init(ROOTS), 2)
    assert TT.BatchLaneState._fields == RT.BatchLaneState._fields
    for f in RT.BatchLaneState._fields:
        r = np.asarray(getattr(rs, f))
        t = getattr(ts, f)
        t = t.numpy() if isinstance(t, torch.Tensor) else t
        assert r.dtype == t.dtype and r.shape == t.shape, f
        np.testing.assert_array_equal(r, t, err_msg=f)


@pytest.mark.parametrize("template", ["ppr", "pagerank"])
def test_float_programs_in_lanes(graphs, template):
    """Float-add programs: within rtol 1e-5 of the JAX package's batch,
    bitwise equal to the port's own sequential runs (ppr rooted past the
    analyzer's 8 probe slots, whose restart vector reads the table's
    length, so its apply must run lane by lane)."""
    rg, tg = graphs
    if template == "ppr":
        rprog, tprog, roots = RD.ppr_program(250), TD.ppr_program(250), \
            np.asarray([250])
    else:
        rprog, tprog, roots = RD.pagerank_program(iters=5), \
            TD.pagerank_program(iters=5), np.asarray([0, 3])
    rp = RT.translate(rprog, rg, RS.ScheduleConfig())
    tp = TT.translate(tprog, tg, TS.ScheduleConfig(), device="cpu")
    rv, ri = rp.run_batch(roots)
    tv, ti = tp.run_batch(roots)
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(np.asarray(ri), ti.numpy())
    for i, r in enumerate(roots):
        v, it = tp.run(roots=int(r))
        assert torch.equal(tv[i], v) and int(ti[i]) == it


def test_apply_lane_probe():
    """Only an apply that gives each lane of a (2, V) batch what it gives
    that lane alone runs once on a batch."""
    V = 300
    f32 = torch.float32
    assert TA.apply_batches_over_lanes(TD.bfs_program().apply, torch.int32,
                                       V)
    assert TA.apply_batches_over_lanes(TD.sssp_program().apply, f32, V)
    assert TA.apply_batches_over_lanes(TD.pagerank_program().apply, f32, V)
    for root in (3, 250):
        assert not TA.apply_batches_over_lanes(TD.ppr_program(root).apply,
                                               f32, V)
    # fooled by 8 slots, caught at the graph's V
    assert TA.apply_is_elementwise(TD.ppr_program(250).apply, f32)


def test_one_read_per_batched_superstep(graphs):
    """A batch makes one device→host read per batched superstep; a slice
    resumed from the state the last one returned reads nothing first, and
    lane_done/lane_stats read nothing."""
    _, tg = graphs
    tp = TT.translate(TD.bfs_program(), tg, TS.ScheduleConfig(),
                      device="cpu")
    reads, steps = tp.lane_reads, tp.lane_supersteps
    state = tp.batch_init(ROOTS)
    while not tp.lane_done(state).all():
        state = tp.run_batch_slice(state, 2)
        tp.lane_stats(state)
    assert tp.lane_supersteps > steps
    assert tp.lane_reads - reads == tp.lane_supersteps - steps
    # admitting into a lane keeps the others' occupancy: still no read
    reads = tp.lane_reads
    state = tp.run_batch_slice(tp.lane_admit(state, 2, 42), 100)
    assert tp.lane_reads - reads == int(state.iters[2])
    # a state from elsewhere (a restore) costs one read first
    reads = tp.lane_reads
    restored = tp.lane_restore(tp.lane_snapshot(state))
    assert tp.lane_done(restored).all()
    assert tp.lane_reads - reads == 2          # the snapshot and the read


# ---------------------------------------------------------------------------
# the lane-axis kernel: wrapper and decomposition
# ---------------------------------------------------------------------------


def _lane_inputs(R, W, V, k, dtype, seed):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, V, (R, W)).astype(np.int32)
    nbr[rng.random((R, W)) < 0.3] = PAD
    nbr[:2] = PAD                                      # PAD-only rows
    wgt = rng.uniform(0.0, 4.0, (R, W)).astype(np.float32)
    if dtype == np.int32:
        vals = rng.integers(-50, 50, (k, V)).astype(np.int32)
    else:
        vals = rng.uniform(-5.0, 5.0, (k, V)).astype(np.float32)
        vals[rng.random((k, V)) < 0.05] = np.nan
    deg = rng.integers(0, 9, V).astype(np.int32)
    act = rng.random((k, V)) < 0.5
    return tuple(torch.as_tensor(a) for a in (nbr, wgt, vals, deg, act))


def _lanes_decomposed(nbr, wgt, values, degrees, active, *, gather, reduce,
                      mask_inactive, K):
    """The lane-axis kernel's decomposition in plain PyTorch.  Pre-pass:
    a vertex-major ``(V, K)`` message table (pad lanes 0) and each
    vertex's K frontier bits, 32 / K vertices a 32-bit word.  Main pass:
    per row, slot by slot in slot order, one word read and one row of K
    messages a live slot, each lane combining the identity for a slot
    that is dead for it."""
    k, V = values.shape
    ident = tref._identity(reduce, values.dtype)
    msg = values if gather in ("copy", "add_w", "mul_w") else \
        tref.gather_msg(gather, values, None, degrees[None, :])
    table = torch.zeros((V, K), dtype=values.dtype)
    table[:, :k] = msg.T
    flat = table.reshape(-1)
    bits = torch.zeros((V, K), dtype=torch.int64)
    bits[:, :k] = active.T.long()
    per_word = 32 // K
    vpad = -(-V // per_word) * per_word
    lane_bits = torch.zeros((vpad, K), dtype=torch.int64)
    lane_bits[:V] = bits
    shifts = (torch.arange(vpad) % per_word)[:, None] * K \
        + torch.arange(K)[None, :]
    words = (lane_bits << shifts).view(-1, per_word * K).sum(1)
    R, W = nbr.shape
    all_lanes = (1 << K) - 1
    acc = torch.full((k, R), ident, dtype=values.dtype)
    any_live = torch.zeros((k, R), dtype=torch.bool)
    combine = {"add": torch.add, "min": torch.minimum,
               "max": torch.maximum}[reduce]
    lanes = torch.arange(k)
    for j in range(W):
        u = nbr[:, j]
        is_pad = u == PAD
        safe = torch.where(is_pad, 0, u).long()
        if mask_inactive:
            at = safe * K
            live_w = (words[at // 32] >> (at % 32)) & all_lanes
        else:
            live_w = torch.full((R,), all_lanes, dtype=torch.int64)
        live_w = torch.where(is_pad, 0, live_w)
        live = ((live_w[None, :] >> lanes[:, None]) & 1) == 1
        m = flat[safe[None, :] * K + lanes[:, None]]
        if gather in ("add_w", "mul_w"):
            m = tref.gather_msg(gather, m, wgt[:, j].to(m.dtype)[None, :],
                                None)
        acc = combine(acc, torch.where(live, m, ident))
        any_live |= live
    return acc, any_live


_LANE_CASES = [(g, r, d, m) for g in tref.GATHER_OPS for r in tref.REDUCE_OPS
               for d in (np.int32, np.float32) for m in (True, False)
               if not (g == "div_deg" and d == np.int32)]


@pytest.mark.parametrize("gather,reduce,dtype,mask", _LANE_CASES)
def test_lane_kernel_decomposition_matches_plain(gather, reduce, dtype,
                                                 mask):
    """Vertex-major messages and K-bit frontier words read through the
    flat view give the per-lane plain results: exactly, but for a float
    add (the plain version's row sum adds in PyTorch's order: rtol 1e-5
    of the sum of the terms' magnitudes); k = 1, 3, 8 and 21 lanes in
    kernels built 1, 4, 8 and 32 lanes wide, widths 8 and 3."""
    for W, k in ((8, 1), (8, 3), (3, 8), (8, 21)):
        K = next(w for w in teb.LANE_WIDTHS if w >= k)
        t = _lane_inputs(37, W, 70, k, dtype, seed=W * 31 + k)
        kw = dict(gather=gather, reduce=reduce, mask_inactive=mask)
        got = _lanes_decomposed(*t, **kw, K=K)
        want = teb.edge_block_reduce_lanes(*t, **kw)
        assert torch.equal(got[1], want[1])
        if dtype == np.float32 and reduce == "add":
            scale = _lanes_decomposed(t[0], t[1], t[2].abs(), t[3], t[4],
                                      **kw, K=K)[0]
            diff = (got[0] - want[0]).abs()
            ok = (diff <= 1e-6 + 1e-5 * scale) | (got[0] == want[0]) \
                | (got[0].isnan() & want[0].isnan())
            assert bool(ok.all())
        else:
            np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())


def test_lane_kernel_wrapper_on_cpu():
    """On CPU tensors the wrapper is the per-lane plain version: each row
    equals the single-lane wrapper; ``need_any=False`` drops the flags; a
    batch wider than one launch takes the same path; bad shapes raise."""
    nbr, wgt, vals, deg, act = _lane_inputs(41, 8, 90, 37, np.int32, 5)
    kw = dict(gather="plus_one", reduce="min")
    red, any_live = teb.edge_block_reduce_lanes(nbr, wgt, vals, deg, act,
                                                **kw)
    assert red.shape == any_live.shape == (37, 41)
    for i in range(37):
        r1, a1 = teb.edge_block_reduce(nbr, wgt, vals[i], deg, act[i], **kw)
        assert torch.equal(red[i], r1) and torch.equal(any_live[i], a1)
    red2, none = teb.edge_block_reduce_lanes(nbr, wgt, vals, deg, act,
                                             need_any=False, **kw)
    assert none is None and torch.equal(red2, red)
    with pytest.raises(ValueError, match="want \\(k, V\\)"):
        teb.edge_block_reduce_lanes(nbr, wgt, vals[0], deg, act[0], **kw)
    with pytest.raises(ValueError, match="true division"):
        teb.edge_block_reduce_lanes(nbr, wgt, vals, deg, act,
                                    gather="div_deg", reduce="add")
    assert teb.edge_block_reduce_lanes.lane_launches == 0   # no card here


@pytest.mark.parametrize("reduce,dtype", [("min", np.int32),
                                          ("max", np.float32),
                                          ("add", np.int32),
                                          ("add", np.float32)])
def test_subrow_combine_lane_axis(graphs, reduce, dtype):
    """The lane axis of subrow_combine equals k single-lane calls, bit for
    bit, on a plan with split hubs (a float add folds lane by lane)."""
    _, tg = graphs
    tp = G.pull_bitmap_plan(G.bucketize(G.reverse(tg), max_width=16))
    assert tp.num_dup > 0
    rng = np.random.default_rng(11)
    sub = (rng.integers(-99, 99, (5, tp.num_subrows)) if dtype == np.int32
           else rng.uniform(-3, 3, (5, tp.num_subrows))).astype(dtype)
    sub = torch.as_tensor(sub)
    ident = tref._identity(reduce, sub.dtype)
    lanes = tpb.subrow_combine(sub, tp, ident, reduce, sub.dtype)
    assert lanes.shape == (5, tg.num_vertices)
    for i in range(5):
        one = tpb.subrow_combine(sub[i], tp, ident, reduce, sub.dtype)
        assert torch.equal(lanes[i], one), i
