"""Port parity: the CUDA kernels' plain PyTorch versions (what the kernel
wrappers run on CPU tensors) against the JAX package's Pallas kernels in
interpret mode, on the same numpy inputs.

Min, max and integer reductions must match exactly.  A float add may
differ by reassociation (the Pallas row sum and the PyTorch row sum add
the W lanes in different orders): ``rtol=1e-5``.  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.kernels import edge_block as reb
from repro.kernels import ops as rops
from repro.kernels import push_ell as rpe
from repro.kernels import ref as rref

import torch
from repro_torch.core import graph as G
from repro_torch.kernels import edge_block as teb
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pull_bitmap as tpb
from repro_torch.kernels import push_ell as tpe
from repro_torch.kernels import push_scatter as tpsc
from repro_torch.kernels import ref as tref
from torch_threads import one_thread  # noqa: F401

PAD = 2**31 - 1
GATHERS = tref.GATHER_OPS
REDUCES = tref.REDUCE_OPS


def _inputs(R, W, V, dtype, seed=0, pad_frac=0.3, nan=False):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, V, (R, W)).astype(np.int32)
    nbr[rng.random((R, W)) < pad_frac] = PAD
    wgt = rng.uniform(0.0, 4.0, (R, W)).astype(np.float32)
    if dtype == np.int32:
        vals = rng.integers(0, 50, V).astype(np.int32)
    else:
        vals = rng.uniform(0.0, 5.0, V).astype(np.float32)
        if nan:
            vals[rng.integers(0, V, max(V // 10, 1))] = np.nan
    deg = rng.integers(0, 9, V).astype(np.int32)
    act = rng.random(V) < 0.5
    return nbr, wgt, vals, deg, act


def _t(*arrs):
    return tuple(torch.as_tensor(a) for a in arrs)


def _j(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _check(ref, got, dtype, reduce):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.dtype == got.dtype, (ref.dtype, got.dtype)
    if dtype == np.float32 and reduce == "add":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, ref)


_CASES = [(g, r, d, m) for g in GATHERS for r in REDUCES
          for d in (np.int32, np.float32) for m in (True, False)
          if not (g == "div_deg" and d == np.int32)]


@pytest.mark.parametrize("gather,reduce,dtype,mask", _CASES)
def test_edge_block_plain_matches_pallas(gather, reduce, dtype, mask):
    args = _inputs(37, 8, 101, dtype, seed=len(gather) + len(reduce))
    r_red, r_any = reb.edge_block_reduce(*_j(*args), gather=gather,
                                         reduce=reduce, mask_inactive=mask,
                                         block_rows=16, interpret=True)
    t_red, t_any = teb.edge_block_reduce_plain(*_t(*args), gather=gather,
                                               reduce=reduce,
                                               mask_inactive=mask)
    _check(r_red, t_red, dtype, reduce)
    np.testing.assert_array_equal(np.asarray(r_any), t_any.numpy())
    # on CPU tensors the kernel wrapper is the plain version
    w_red, w_any = teb.edge_block_reduce(*_t(*args), gather=gather,
                                         reduce=reduce, mask_inactive=mask)
    assert torch.equal(w_red, t_red) and torch.equal(w_any, t_any)


@pytest.mark.parametrize("R,W,V,reduce", [
    (1, 8, 33, "min"), (130, 8, 1000, "add"), (5, 1, 7, "max"),
    (19, 16, 65, "add"), (257, 8, 31, "min")])
def test_edge_block_ragged_shapes(R, W, V, reduce):
    args = _inputs(R, W, V, np.float32, seed=R + W)
    r_red, r_any = reb.edge_block_reduce(*_j(*args), gather="add_w",
                                         reduce=reduce, block_rows=8,
                                         interpret=True)
    t_red, t_any = teb.edge_block_reduce_plain(*_t(*args), gather="add_w",
                                               reduce=reduce)
    _check(r_red, t_red, np.float32, reduce)
    np.testing.assert_array_equal(np.asarray(r_any), t_any.numpy())


@pytest.mark.parametrize("reduce", ["min", "max"])
def test_edge_block_nan_propagates_like_pallas(reduce):
    args = _inputs(64, 8, 50, np.float32, seed=11, pad_frac=0.1, nan=True)
    r_red, _ = reb.edge_block_reduce(*_j(*args), gather="copy",
                                     reduce=reduce, mask_inactive=False,
                                     block_rows=16, interpret=True)
    t_red, _ = teb.edge_block_reduce_plain(*_t(*args), gather="copy",
                                           reduce=reduce, mask_inactive=False)
    assert np.isnan(np.asarray(r_red)).any()
    np.testing.assert_array_equal(np.asarray(r_red), t_red.numpy())


def test_edge_block_refuses_non_menu_and_int_division():
    args = _t(*_inputs(4, 8, 10, np.int32))
    with pytest.raises(ValueError):
        teb.edge_block_reduce(*args, gather="div_deg", reduce="add")
    with pytest.raises(ValueError):
        teb.edge_block_reduce(*args, gather="square", reduce="add")


def _two_stage(nbr, wgt, values, degrees, active, *, gather, reduce,
               mask_inactive, block_live=None, block_rows=None):
    """Kernel 1's decomposition in plain PyTorch: a pre-pass tabulates the
    frontier as packed 32-bit words (under ``mask_inactive``) and the
    weight-free gather's message a vertex; then each row is reduced slot
    by slot, in slot order, from one bit and one message a live slot, a
    dead slot as the identity; with ``block_live``, a dead block's rows
    hold the identity and any=False."""
    ident = tref._identity(reduce, values.dtype)
    # stage 1: frontier words (bit u % 32 of word u // 32) and messages
    V = values.shape[0]
    pad = torch.zeros(-(-V // 32) * 32, dtype=torch.int64)
    pad[:V] = active.long()
    words = (pad.view(-1, 32) << torch.arange(32)).sum(1)
    msg = values if gather in ("copy", "add_w", "mul_w") else \
        tref.gather_msg(gather, values, None, degrees)
    # stage 2: one bit and one message a live slot
    R, W = nbr.shape
    acc = torch.full((R,), ident, dtype=values.dtype)
    any_live = torch.zeros((R,), dtype=torch.bool)
    combine = {"add": torch.add, "min": torch.minimum,
               "max": torch.maximum}[reduce]
    for j in range(W):
        u = nbr[:, j]
        is_pad = u == PAD
        safe = torch.where(is_pad, 0, u).long()
        live = ~is_pad
        if mask_inactive:
            live &= ((words[safe // 32] >> (safe % 32)) & 1) == 1
        m = msg[safe]
        if gather in ("add_w", "mul_w"):
            m = tref.gather_msg(gather, m, wgt[:, j].to(m.dtype), None)
        acc = combine(acc, torch.where(live, m, ident))
        any_live |= live
    if block_live is not None:
        dead = (block_live == 0).repeat_interleave(block_rows)[:R]
        acc = torch.where(dead, ident, acc)
        any_live &= ~dead
    return acc, any_live


@pytest.mark.parametrize("gather,reduce,dtype,mask", _CASES)
def test_edge_block_two_stage_matches_plain(gather, reduce, dtype, mask):
    """The bitmap-and-message decomposition the CUDA kernel runs equals the
    plain version: exactly, but for a float add (the plain version's row
    sum adds in PyTorch's order: rtol 1e-5); over NaN values, int32
    values that wrap, PAD-only rows, widths 8 and 3, with and without
    block skipping."""
    rng = np.random.default_rng(len(gather) * 7 + len(reduce))
    for W in (8, 3):
        nbr, wgt, vals, deg, act = _inputs(53, W, 70, dtype, seed=W,
                                           nan=dtype == np.float32)
        nbr[:3] = PAD                                  # PAD-only rows
        if dtype == np.int32:                          # values that wrap
            big = rng.random(70) < 0.3
            vals[big] = 2**31 - 1 - rng.integers(0, 3, int(big.sum()))
            nbr[3, 0], vals[0] = 0, 2**31 - 1
        live = torch.as_tensor(rng.random(-(-53 // 16)) < 0.5)
        for blk in (None, live):
            kw = dict(gather=gather, reduce=reduce, mask_inactive=mask,
                      block_live=blk, block_rows=16 if blk is not None
                      else None)
            got = _two_stage(*_t(nbr, wgt, vals, deg, act), **kw)
            want = teb.edge_block_reduce_plain(
                *_t(nbr, wgt, vals, deg, act), **kw)
            _check(want[0].numpy(), got[0], dtype, reduce)
            assert torch.equal(got[1], want[1])
            if blk is None and (dtype, gather, reduce, mask) == (
                    np.int32, "plus_one", "min", False):
                assert int(got[0][3]) < 0              # a wrap was seen


_PUSH_CASES = [(g, d, 20, 8, 77) for g in GATHERS
               for d in (np.int32, np.float32)
               if not (g == "div_deg" and d == np.int32)] \
    + [("add_w", np.float32, 3, 4, 9), ("plus_one", np.int32, 1, 8, 5)]


@pytest.mark.parametrize("gather,dtype,C,W,V", _PUSH_CASES)
def test_push_message_plain_matches_pallas(gather, dtype, C, W, V):
    nbr, wgt, vals, deg, _ = _inputs(C, W, V, dtype, seed=C * W)
    src = np.random.default_rng(C).integers(0, V, C).astype(np.int32)
    ref = rpe.push_ell_message_block(*_j(nbr, wgt, src, vals, deg),
                                     gather=gather, block_rows=8,
                                     interpret=True)
    got = tpe.push_ell_message_block_plain(*_t(nbr, wgt, src, vals, deg),
                                           gather=gather)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    wrapped = tpe.push_ell_message_block(*_t(nbr, wgt, src, vals, deg),
                                         gather=gather)
    assert torch.equal(wrapped, got)


def _graph_pair(V=300, E=2400, seed=0):
    from repro.core import graph as RG
    src, dst = RG.rmat_edges(V, E, seed=seed)
    w = np.random.default_rng(seed).uniform(0.5, 3, len(src)) \
        .astype(np.float32)
    return (RG.from_edge_list(src, dst, num_vertices=V, weights=w),
            G.from_edge_list(src, dst, num_vertices=V, weights=w))


@pytest.mark.parametrize("gather,reduce,dtype", [
    ("copy", "min", np.int32), ("plus_one", "min", np.int32),
    ("add_w", "min", np.float32), ("mul_w", "max", np.float32),
    ("copy", "add", np.int32)])
@pytest.mark.parametrize("capacity", [None, 64])
def test_compacted_push_reduce_matches(gather, reduce, dtype, capacity):
    from repro.core import graph as RG
    rg, tg = _graph_pair(seed=3)
    rfe, tfe = RG.forward_ell(rg, width=8), G.forward_ell(tg, width=8)
    rng = np.random.default_rng(5)
    V = tg.num_vertices
    vals = (rng.integers(0, 40, V) if dtype == np.int32
            else rng.uniform(0, 4, V)).astype(dtype)
    deg = np.asarray(rg.out_degrees).astype(np.int32)
    act = rng.random(V) < (0.02 if capacity else 0.4)
    rows = int(np.asarray(rfe.rows_per_vertex)[act].sum())
    cap = capacity if capacity is not None else max(rfe.num_rows, 1)
    assert rows <= cap
    r_red, r_t = rops.push_ell_reduce(
        rfe.row_src, rfe.dst, rfe.weights, *_j(vals, deg, act),
        num_rows=rfe.num_rows, capacity=cap, gather=gather, reduce=reduce)
    t_red, t_t = tops.push_ell_reduce(
        tfe.row_src, tfe.dst, tfe.weights, *_t(vals, deg, act),
        num_rows=tfe.num_rows, capacity=cap, gather=gather, reduce=reduce)
    np.testing.assert_array_equal(np.asarray(r_red), t_red.numpy())
    np.testing.assert_array_equal(np.asarray(r_t), t_t.numpy())
    # and both equal the dense push-scatter oracle
    src, dst, wts = G.to_coo(tg)
    o_red, o_t = tref.push_scatter_reduce_ref(
        *_t(src, dst, wts, vals, deg, act), gather=gather, reduce=reduce)
    np.testing.assert_array_equal(o_red.numpy(), t_red.numpy())
    np.testing.assert_array_equal(o_t.numpy(), t_t.numpy())


@pytest.mark.parametrize("reduce", REDUCES)
def test_oracles_match_reference_oracles(reduce):
    args = _inputs(40, 8, 90, np.float32, seed=21)
    r = rref.edge_block_reduce_ref(*_j(*args), gather="mul_w", reduce=reduce)
    t = tref.edge_block_reduce_ref(*_t(*args), gather="mul_w", reduce=reduce)
    _check(r[0], t[0], np.float32, reduce)
    np.testing.assert_array_equal(np.asarray(r[1]), t[1].numpy())
    rng = np.random.default_rng(2)
    E, V = 300, 60
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    w = rng.uniform(0, 2, E).astype(np.float32)
    vals = rng.integers(0, 30, V).astype(np.int32)
    deg = rng.integers(0, 5, V).astype(np.int32)
    act = rng.random(V) < 0.5
    r = rref.push_scatter_reduce_ref(*_j(src, dst, w, vals, deg, act),
                                     gather="plus_one", reduce=reduce)
    t = tref.push_scatter_reduce_ref(*_t(src, dst, w, vals, deg, act),
                                     gather="plus_one", reduce=reduce)
    np.testing.assert_array_equal(np.asarray(r[0]), t[0].numpy())
    np.testing.assert_array_equal(np.asarray(r[1]), t[1].numpy())


@pytest.mark.parametrize("reduce,dtype", [("min", np.int32),
                                          ("add", np.float32),
                                          ("max", np.float32)])
def test_subrow_combine_and_message_table_match(reduce, dtype):
    from repro.core import graph as RG
    from repro.kernels import pull_bitmap as rpb
    rg, tg = _graph_pair(seed=9)
    rp = RG.pull_bitmap_plan(RG.bucketize(RG.reverse(rg), max_width=16))
    tp = G.pull_bitmap_plan(G.bucketize(G.reverse(tg), max_width=16))
    assert tp.num_dup > 0            # split hubs exercise the dup scatter
    rng = np.random.default_rng(4)
    ident = tref._identity(reduce, torch.from_numpy(np.zeros(1, dtype)).dtype)
    sub = (rng.integers(0, 99, tp.num_subrows) if dtype == np.int32
           else rng.uniform(0, 3, tp.num_subrows)).astype(dtype)
    r = rpb.subrow_combine(jnp.asarray(sub), rp, ident, reduce,
                           jnp.dtype(dtype))
    t = tpb.subrow_combine(torch.as_tensor(sub), tp, ident, reduce,
                           torch.as_tensor(sub).dtype)
    _check(r, t, dtype, reduce)
    V = tg.num_vertices
    vals = rng.uniform(0, 5, V).astype(np.float32)
    deg = np.asarray(rg.out_degrees).astype(np.int32)
    act = rng.random(V) < 0.5
    r = rpb.message_table(*_j(vals, deg, act), gather="div_deg",
                          gather_fn=None, reduce="add", mask_inactive=True,
                          dtype=jnp.float32)
    t = tpb.message_table(*_t(vals, deg, act), gather="div_deg",
                          gather_fn=None, reduce="add", mask_inactive=True,
                          dtype=torch.float32)
    np.testing.assert_array_equal(np.asarray(r), t.numpy())


# ---------------------------------------------------------------------------
# kernel 2: the block-skipping edge-block reduce (_kernel_skip)
# ---------------------------------------------------------------------------


def _block_live(kind, nb, rng):
    if kind == "all_dead":
        return np.zeros(nb, np.int8)
    if kind == "all_live":
        return np.ones(nb, np.int8)
    return (rng.random(nb) < 0.5).astype(np.int8)


@pytest.mark.parametrize("reduce,dtype", [(r, d) for r in REDUCES
                                          for d in (np.int32, np.float32)])
@pytest.mark.parametrize("kind", ["random", "all_dead", "all_live"])
def test_edge_block_skip_plain_matches_pallas(reduce, dtype, kind):
    """Ragged R (not a multiple of block_rows) and a block_live that is not
    conservative: rows of a block marked dead hold the identity and
    any=False even where they have live slots, as _kernel_skip writes."""
    R, br = 77, 16
    args = _inputs(R, 8, 120, dtype, seed=R + len(reduce),
                   nan=dtype == np.float32)
    live = _block_live(kind, -(-R // br), np.random.default_rng(5))
    gather = "add_w" if dtype == np.float32 else "plus_one"
    r_red, r_any = reb.edge_block_reduce(
        *_j(*args), gather=gather, reduce=reduce, block_rows=br,
        interpret=True, block_live=jnp.asarray(live))
    t_red, t_any = teb.edge_block_reduce_plain(
        *_t(*args), gather=gather, reduce=reduce, block_rows=br,
        block_live=torch.as_tensor(live))
    _check(r_red, t_red, dtype, reduce)
    np.testing.assert_array_equal(np.asarray(r_any), t_any.numpy())
    w_red, w_any = teb.edge_block_reduce(
        *_t(*args), gather=gather, reduce=reduce, block_rows=br,
        block_live=torch.as_tensor(live).bool())
    assert torch.equal(w_any, t_any)
    assert torch.equal(w_red.isnan(), t_red.isnan())
    assert torch.equal(torch.nan_to_num(w_red), torch.nan_to_num(t_red))
    if kind == "random":
        full_any = teb.edge_block_reduce_plain(*_t(*args), gather=gather,
                                               reduce=reduce)[1]
        dead = ~torch.as_tensor(live).bool().repeat_interleave(br)[:R]
        assert bool((full_any & dead).any())   # a live row was marked dead


def test_edge_block_skip_refuses_bad_liveness():
    args = _t(*_inputs(20, 8, 30, np.int32))
    for live, rows in ((torch.ones(2, dtype=torch.bool), 8),
                       (torch.ones(2, dtype=torch.int32), 16),
                       (torch.ones(2, dtype=torch.bool), None)):
        with pytest.raises(ValueError):
            teb.edge_block_reduce(*args, gather="copy", reduce="min",
                                  block_live=live, block_rows=rows)


# ---------------------------------------------------------------------------
# kernel 4: segment reduce over a sorted stream
# ---------------------------------------------------------------------------


def _segments(E, S, dtype, seed, nan=False, tail=0):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, S, E)).astype(np.int32)
    seg[seg == S // 2] = S // 2 + 1 if S > 2 else seg[seg == S // 2]
    if dtype == np.int32:
        val = rng.integers(-1000, 1000, E).astype(np.int32)
    else:
        val = rng.uniform(-5, 5, E).astype(np.float32)
        if nan:
            val[rng.integers(0, E, max(E // 20, 1))] = np.nan
    if tail:
        seg = np.concatenate([seg, np.full(tail, 2**31 - 1, np.int32)])
        val = np.concatenate([val, np.ones(tail, dtype)])
    return seg, val


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("E,S,tail", [(500, 97, 0), (301, 1000, 11),
                                      (64, 1, 0)])
def test_segment_reduce_plain_matches_pallas(reduce, dtype, E, S, tail):
    """Empty segments hold the identity, the INT_MAX tail is dropped, min
    and max carry NaN; min, max and int exact, float add rtol 1e-5."""
    from repro.kernels import segment_sum as rss
    seg, val = _segments(E, S, dtype, seed=E + S, nan=dtype == np.float32,
                         tail=tail)
    ref = rss.segment_reduce(jnp.asarray(seg), jnp.asarray(val), S,
                             reduce=reduce, block_e=128, interpret=True)
    got = tops.segment_reduce(*_t(seg, val), S, reduce=reduce)
    if dtype == np.float32 and reduce == "add":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    else:
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert got.dtype == torch.from_numpy(val).dtype
    if S > E:
        ident = tref._identity(reduce, got.dtype)
        empty = np.setdiff1d(np.arange(S), seg)
        assert bool((got[torch.as_tensor(empty)] == ident).all())


@pytest.mark.parametrize("reduce", REDUCES)
def test_segment_reduce_ref_matches_jax_segment_ops(reduce):
    seg, val = _segments(400, 50, np.float32, seed=8)
    ref = rref.segment_reduce_ref(jnp.asarray(seg), jnp.asarray(val), 50,
                                  reduce=reduce)
    got = tref.segment_reduce_ref(*_t(seg, val), 50, reduce=reduce)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the chunk-streamed push scatter (coo_chunks)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gather,reduce,dtype", [
    ("plus_one", "min", np.int32), ("add_w", "min", np.float32),
    ("copy", "max", np.int32), ("copy", "add", np.int32)])
@pytest.mark.parametrize("num_chunks", [1, 8])
def test_push_scatter_reduce_matches(gather, reduce, dtype, num_chunks):
    from repro.kernels import push_scatter as rps
    rng = np.random.default_rng(num_chunks)
    E, V = 333, 70
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    w = rng.uniform(0, 2, E).astype(np.float32)
    vals = (rng.integers(0, 30, V) if dtype == np.int32
            else rng.uniform(0, 3, V)).astype(dtype)
    deg = rng.integers(0, 5, V).astype(np.int32)
    act = rng.random(V) < 0.3
    for r, t in zip(rps.chunk_coo(*_j(dst, src, w), num_chunks=num_chunks),
                    tpsc.chunk_coo(*_t(dst, src, w), num_chunks=num_chunks)):
        np.testing.assert_array_equal(np.asarray(r), t.numpy())
    r = rops.push_scatter_reduce(*_j(src, dst, w, vals, deg, act),
                                 gather=gather, reduce=reduce,
                                 num_chunks=num_chunks)
    t = tops.push_scatter_reduce(*_t(src, dst, w, vals, deg, act),
                                 gather=gather, reduce=reduce,
                                 num_chunks=num_chunks)
    for a, b in zip(r, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    o = tref.push_scatter_reduce_ref(*_t(src, dst, w, vals, deg, act),
                                     gather=gather, reduce=reduce)
    assert all(torch.equal(a, b) for a, b in zip(o, t))


# ---------------------------------------------------------------------------
# kernel 4's decomposition: tiles, a segmented scan, ordered carries
# ---------------------------------------------------------------------------


def _combine_fn(reduce, is_float):
    """gather_ops.cuh's combine on scalars: float32 arithmetic, int32 add
    wrapping, min and max propagating NaN."""
    if reduce == "add":
        if is_float:
            return lambda a, b: np.float32(np.float32(a) + np.float32(b))
        return lambda a, b: (a + b + 2**31) % 2**32 - 2**31
    if reduce == "min":
        return lambda acc, m: acc if (acc < m or acc != acc) else m
    return lambda acc, m: acc if (acc > m or acc != acc) else m


def _tiled_segment_reduce(seg, val, S, reduce, threads, items):
    """Kernel 4's decomposition (``csrc/segment_sum.cu``) at a tile of
    ``threads × items`` elements: a fill; per tile, each thread's runs,
    an exclusive segmented scan over the threads carrying the open run
    in, each finished run written out or, where it crosses the tile's
    edge, to the tile's carries, with the tile's flags written by the
    thread that ends its last run; then each run that crosses tiles
    folded from its carries in tile order by the tile where it starts."""
    n, tile = len(seg), threads * items
    is_float = val.dtype == np.float32
    cast = np.float32 if is_float else int
    comb = _combine_fn(reduce, is_float)
    ident = cast(tref._identity(reduce, torch.float32 if is_float
                                else torch.int32))
    out = [ident] * S
    tiles = -(-n // tile)
    cf, cl, flags = [None] * tiles, [None] * tiles, [None] * tiles
    beyond = -2 if n and int(seg[n - 1]) == -1 else -1
    for b in range(tiles):
        base = b * tile
        tile_end = min(base + tile, n)
        last_i = tile_end - 1
        cont_prev = base > 0 and seg[base - 1] == seg[base]
        cont_next = tile_end < n and seg[tile_end] == seg[tile_end - 1]

        def finish(key, agg, starts, ends):
            to_first, to_last = starts and cont_prev, ends and cont_next
            if to_first:
                cf[b] = agg
            if to_last:
                cl[b] = agg
            if not (to_first or to_last) and 0 <= key < S:
                out[key] = agg
            if ends:
                assert flags[b] is None, "a tile's flags written twice"
                flags[b] = (starts, cont_prev, cont_next)

        K = [[int(seg[i]) if i < n else beyond
              for i in range(base + t * items, base + (t + 1) * items)]
             for t in range(threads)]
        Vs = [[cast(val[i]) if i < n else ident
               for i in range(base + t * items, base + (t + 1) * items)]
              for t in range(threads)]
        ef, ea = False, ident        # exclusive scan: (head seen, partial)
        for t in range(threads):
            k, v, i0 = K[t], Vs[t], base + t * items
            head_in, first_end, acc, first_agg = False, items - 1, v[0], None
            for j in range(1, items):
                if k[j] != k[j - 1]:
                    if not head_in:
                        first_agg, first_end, head_in = acc, j - 1, True
                    else:
                        finish(k[j - 1], acc, False, i0 + j - 1 == last_i)
                    acc = v[j]
                else:
                    acc = comb(acc, v[j])
            if not head_in:
                first_agg = acc
            head0 = t > 0 and k[0] != K[t - 1][-1]
            if i0 < n:
                carried = t > 0 and not head0
                starts = t == 0 or (carried and not ef)
                full = comb(ea, first_agg) if carried else first_agg
                ends7 = t == threads - 1 or K[t + 1][0] != k[-1]
                if head_in:
                    finish(k[0], full, starts, i0 + first_end == last_i)
                    if ends7:
                        finish(k[-1], acc, False, i0 + items - 1 == last_i)
                elif ends7:
                    finish(k[0], full, starts, i0 + items - 1 == last_i)
            f = head_in or head0
            if t == 0:
                ef, ea = f, acc
            else:
                ea = acc if f else comb(ea, acc)
                ef = ef or f
    assert all(fl is not None for fl in flags), "a tile without flags"
    for b in range(tiles):
        single, cont_prev, cont_next = flags[b]
        if not cont_next or (single and cont_prev):
            continue
        key = int(seg[(b + 1) * tile])
        if not 0 <= key < S:
            continue
        acc = cl[b]
        for j in range(b + 1, tiles):
            acc = comb(acc, cf[j])
            if not (flags[j][0] and flags[j][2]):
                break
        out[key] = acc
    return np.array(out, dtype=val.dtype)


_TILE_SHAPES = ((2, 3), (4, 2), (3, 4))       # threads × items a tile


def _tiling_case(case, dtype, rng):
    """(seg, val, S) of a kernel 4 tiling case; tiles of 6, 8 or 12
    elements (``_TILE_SHAPES``)."""
    S = 40
    if case == "hub":           # a hub over many tiles, at an odd offset
        seg = np.sort(np.concatenate([rng.integers(0, S, 61),
                                      np.full(90, 17)]))
    elif case == "boundary":    # runs that end on tile boundaries
        lengths = [24, 11, 1, 48, 3, 9, 12, 6, 1, 23]
        seg = np.repeat(np.arange(0, 2 * len(lengths), 2), lengths)
    elif case == "int_max_tail":     # a valid run, then INT_MAX mid-tile
        seg = np.concatenate([np.sort(rng.integers(0, S, 29)),
                              np.full(31, PAD)])
    elif case == "small":       # fewer elements than one tile
        seg = np.sort(rng.integers(0, S, 5))
    elif case == "empty":
        seg = np.zeros(0, np.int64)
    elif case == "sparse":      # most segments empty
        S = 1000
        seg = np.sort(rng.integers(0, S, 70))
    else:                       # nan_carry: NaN in a hub's first tile
        seg = np.sort(np.concatenate([rng.integers(0, S, 20),
                                      np.full(60, 11)]))
    seg = seg.astype(np.int32)
    E = len(seg)
    if dtype == np.int32:
        val = rng.integers(-1000, 1000, E).astype(np.int32)
        if case == "hub":       # an int add that wraps
            hub = seg == 17
            val[hub] = 2**31 - 1 - rng.integers(0, 5, int(hub.sum()))
    else:
        val = rng.uniform(-5, 5, E).astype(np.float32)
        if case == "nan_carry":
            val[np.flatnonzero(seg == 11)[0]] = np.nan
        elif E:
            val[rng.integers(0, E, max(E // 20, 1))] = np.nan
    return seg, val, S


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("case", ["hub", "boundary", "int_max_tail",
                                  "small", "empty", "sparse", "nan_carry"])
def test_segment_reduce_tiled_matches_plain(reduce, dtype, case):
    """Kernel 4's tiled decomposition with ordered carries equals the
    plain version and the JAX kernel (interpret mode; its oracle at E =
    0, which the kernel's padding does not take): min, max and int32
    exactly, float add within rtol 1e-5 (the tiles sum in another
    order), over tiles of 6, 8 and 12 elements."""
    from repro.kernels import segment_sum as rss
    rng = np.random.default_rng(len(case) * 11 + len(reduce))
    seg, val, S = _tiling_case(case, dtype, rng)
    want = tref.segment_reduce_ref(*_t(seg, val), S, reduce=reduce).numpy()
    if len(seg):
        jax_out = rss.segment_reduce(jnp.asarray(seg), jnp.asarray(val), S,
                                     reduce=reduce, block_e=16,
                                     interpret=True)
    else:
        jax_out = rref.segment_reduce_ref(jnp.asarray(seg), jnp.asarray(val),
                                          S, reduce=reduce)
    float_add = dtype == np.float32 and reduce == "add"
    if float_add:
        np.testing.assert_allclose(want, np.asarray(jax_out), rtol=1e-5,
                                   atol=1e-5)
    else:
        np.testing.assert_array_equal(want, np.asarray(jax_out))
    for threads, items in _TILE_SHAPES:
        got = _tiled_segment_reduce(seg, val, S, reduce, threads, items)
        assert got.dtype == want.dtype
        if float_add:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)
    if case == "nan_carry" and dtype == np.float32 and reduce != "add":
        assert np.isnan(want[11])       # the NaN crossed tiles as a carry


# ---------------------------------------------------------------------------
# kernel 3 fused with the combine: the contract of the fused push kernel
# ---------------------------------------------------------------------------


def _fused_push_emulation(sel, ok, row_src, ell_dst, ell_wgt, values,
                          degrees, *, gather, reduce, order_seed):
    """The fused push kernel's contract, slot by slot in a shuffled order:
    only compacted rows with ``ok`` and slots whose id is a vertex are
    visited (no PAD, no dummy slot), each message combined into a ``(V,)``
    identity table as the kernel's atomics do (min/max replace only on an
    improvement, NaN over a number; int add wraps), and each visited
    destination marked touched."""
    V = values.shape[0]
    is_float = values.dtype.is_floating_point
    comb = _combine_fn(reduce, is_float)
    cast = np.float32 if is_float else int
    table = [cast(tref._identity(reduce, values.dtype))] * V
    touched = [False] * V
    rows = sel[ok].long()
    dst = ell_dst[rows]
    src = row_src[rows].long()
    msg = tref.gather_msg(gather, values[src][:, None].expand(dst.shape),
                          ell_wgt[rows].to(values.dtype),
                          degrees[src][:, None].expand(dst.shape))
    slots = [(c, j) for c in range(dst.shape[0]) for j in range(dst.shape[1])
             if 0 <= int(dst[c, j]) < V]
    for i in np.random.default_rng(order_seed).permutation(len(slots)):
        c, j = slots[i]
        u, m = int(dst[c, j]), cast(msg[c, j].item())
        table[u] = comb(table[u], m)
        touched[u] = True
    return (torch.as_tensor(np.array(table, dtype=np.float32 if is_float
                                     else np.int32)),
            torch.as_tensor(touched))


_FUSED_CASES = [(g, r, d) for g in GATHERS for r in REDUCES
                for d in (np.int32, np.float32)
                if not (g == "div_deg" and d == np.int32)
                and not (r == "add" and d == np.float32)]


@pytest.mark.parametrize("gather,reduce,dtype", _FUSED_CASES)
@pytest.mark.parametrize("touched", [True, False])
def test_fused_push_matches_plain_and_jax(gather, reduce, dtype, touched):
    """The fused push kernel's contract (only valid slots of live rows,
    combined in any order, into a ``(V,)`` table) equals its plain
    version (messages, then ``scatter_reduce_`` with PAD to the dummy
    slot) and the JAX ``push_ell_reduce`` with its Pallas message stage in
    interpret mode, exactly, for every legal (gather, reduce, dtype): over
    all-PAD rows, slots past the live count, a destination receiving
    hundreds of messages, NaN and ±0 values, and random, empty and full
    frontiers."""
    rng = np.random.default_rng(len(gather) * 5 + len(reduce))
    V, R, W = 60, 120, 8
    row_src = np.sort(rng.integers(0, V, R)).astype(np.int32)
    dst = rng.integers(0, V, (R, W)).astype(np.int32)
    dst[rng.random((R, W)) < 0.35] = 7         # a hub destination
    dst[rng.random((R, W)) < 0.25] = PAD
    dst[:3] = PAD                              # all-PAD rows
    wgt = rng.uniform(0.5, 4.0, (R, W)).astype(np.float32)
    if dtype == np.int32:
        vals = rng.integers(-50, 50, V).astype(np.int32)
        vals[:4] = 2**31 - 1 - np.arange(4)    # an int add that wraps
    else:
        vals = rng.uniform(-5, 5, V).astype(np.float32)
        vals[rng.integers(0, V, 3)] = np.nan
        vals[10:14] = [0.0, -0.0, 0.0, -0.0]
    deg = rng.integers(0, 9, V).astype(np.int32)
    assert int((dst == 7).sum()) >= 200
    for act in (rng.random(V) < 0.5, np.zeros(V, bool), np.ones(V, bool)):
        live = torch.as_tensor(act[row_src])
        cap = R + 5                            # slots past the live count
        sel, ok = tpe.compact_rows(live, R, cap)
        args = _t(row_src, dst, wgt, vals, deg)
        kw = dict(reduce=reduce, identity=tref._identity(
            reduce, args[3].dtype), num_vertices=V, dtype=args[3].dtype,
            emit_touched=touched)
        got = tpe.push_ell_fused_reduce(sel, ok, *args, gather=gather, **kw)
        plain = tpe.push_ell_fused_reduce_plain(sel, ok, *args,
                                                gather=gather, **kw)
        emu = _fused_push_emulation(sel, ok, *args, gather=gather,
                                    reduce=reduce, order_seed=int(act.sum()))
        via = tpe.compacted_push_reduce(
            args[0], args[1], args[2], live, args[3], args[4], num_rows=R,
            capacity=cap, gather_fn=None, gather_module=gather,
            use_kernels=True, **kw)
        r_red, r_t = rops.push_ell_reduce(
            *_j(row_src, dst, wgt, vals, deg, act), num_rows=R,
            capacity=cap, gather=gather, reduce=reduce, use_pallas=True,
            emit_touched=touched)
        for red, t in (got, plain, via):
            np.testing.assert_array_equal(red.numpy(), np.asarray(r_red))
            np.testing.assert_array_equal(red.numpy(), emu[0].numpy())
            if touched:
                np.testing.assert_array_equal(t.numpy(), np.asarray(r_t))
                assert torch.equal(t, emu[1])
            else:
                assert t is None and r_t is None


def test_fused_push_refuses_non_menu_and_int_division():
    live = torch.ones(4, dtype=torch.bool)
    sel, ok = tpe.compact_rows(live, 4, 4)
    args = _t(np.arange(4, dtype=np.int32), np.zeros((4, 8), np.int32),
              np.ones((4, 8), np.float32), np.arange(4, dtype=np.int32),
              np.ones(4, np.int32))
    kw = dict(reduce="min", identity=2**31 - 1, num_vertices=4,
              dtype=torch.int32)
    with pytest.raises(ValueError):
        tpe.push_ell_fused_reduce(sel, ok, *args, gather="div_deg", **kw)
    with pytest.raises(ValueError):
        tpe.push_ell_fused_reduce(sel, ok, *args, gather="square", **kw)
    with pytest.raises(ValueError):
        tpe.compacted_push_reduce(*args[:3], live, *args[3:], num_rows=4,
                                  capacity=4, gather_fn=None,
                                  gather_module=None, use_kernels=True,
                                  **kw)
