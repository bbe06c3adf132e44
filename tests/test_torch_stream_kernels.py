"""Port parity: the streamed engine's kernel routes, on the CPU.

The fused lane sweep's accumulate mode (``edge_block.edge_block_fold_lanes
(accumulate=True)``, ``csrc/edge_block.cu``'s ``edge_block_fold_kernel``)
and the lane kernels' pre-pass run once for many partitions
(``lanes_prepare`` / ``edge_block_prepare`` / ``push_lanes_prepare`` and
``prepared=``) run only on the card, where ``chip_smoke.py`` holds them
against their plain versions.  Here their decompositions are held against
the plain versions bit for bit and against the JAX package's streamed
partial (``jax.ops.segment_*`` over each partition, combined in partition
order; in value, since JAX leaves the sign of a tied zero to its order):

* the fold over a partition store's pull partitions (an owner's rows in
  several partitions, a hub's rows crossing warp and 256-row block edges,
  pad rows of owner ``V``), launch by launch: runs of equal owners folded
  a warp at a time, a whole run combined into the running table
  (read-combine-store), pieces across warp and block edges combined in a
  shuffled order as the atomics would, ``got`` OR-ed;
* the pre-pass's tables (the K-bit frontier words and the vertex-major
  messages, modelled here as ``lanes_pack_kernel`` lays them out) decoded
  back as the main kernels read them, equal to the plain gather; every
  route called with a pre-pass's tables equal to its call without;
* the lane push's ``got`` over push partitions against the JAX package's
  ``segment_max(live) > 0``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.kernels import ref as rref

import torch
from repro_torch.core import graph as G
from repro_torch.core import preprocess
from repro_torch.kernels import edge_block as teb
from repro_torch.kernels import lanes as tlanes
from repro_torch.kernels import push_ell as tpe
from repro_torch.kernels import ref as tref


class _View:
    """A streamed pull partition as the fold's flat view."""

    def __init__(self, entry, rows=None):
        rows = entry["key"].shape[0] if rows is None else rows
        self.flat_dst = entry["slot"][:rows]
        self.flat_wgt = entry["wgt"][:rows]
        self.owner8 = entry["key"][:rows]


def _hub_store(parts=2):
    """A partition store whose hub (vertex 3) receives 6,000 in-edges, so
    its rows in each pull partition (about 375) cross warp and 256-row
    block edges; every vertex also receives from every partition."""
    rng = np.random.default_rng(21)
    V = 300
    src = np.concatenate([rng.integers(0, V, 4000),
                          rng.integers(0, V, 6000)])
    dst = np.concatenate([rng.integers(0, V, 4000), np.full(6000, 3)])
    w = rng.uniform(0.5, 4.0, len(src)).astype(np.float32)
    g = G.from_edge_list(src, dst, weights=w, num_vertices=V)
    cuts = G.edge_interval_cuts(g.out_degrees.numpy(), parts)
    return g, preprocess.PartitionStore(g, cuts)


def _words(bits):
    """A flat bool tensor packed 32 a word (bit i of word w is bits[32 w
    + i]), as int32 words holding the uint32 patterns."""
    n = bits.shape[0]
    b = torch.nn.functional.pad(bits.to(torch.int64), (0, (-n) % 32))
    w = (b.reshape(-1, 32) << torch.arange(32, dtype=torch.int64)).sum(1)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def _pack(values, degrees, active, rows, K, *, gather, mask_inactive):
    """``lanes_pack_kernel``'s tables for the lanes ``rows`` (at most K rows
    of the ``(k', V)`` state): ``(bits, msg)``.  Bit ``u K + l`` of
    ``bits`` is lane l's ``active[u]`` (pad lanes 0); ``msg[u K + l]`` lane
    l's message of u: the gather's, for ``plus_one`` and ``div_deg``, else
    the value (pad lanes 0)."""
    V = active.shape[1]
    k = len(rows)
    bits = None
    if mask_inactive:
        act = torch.zeros((V, K), dtype=torch.bool)
        act[:, :k] = active[list(rows)].T
        bits = _words(act.reshape(-1))
    m = torch.zeros((V, K), dtype=values.dtype)
    v = values[list(rows)].T
    if gather in ("plus_one", "div_deg"):
        v = tref.gather_msg(gather, v, torch.zeros_like(v),
                            degrees[:, None]).to(values.dtype)
    m[:, :k] = v
    return bits, m.reshape(-1)


def _decode(bits, msg, K, l, nbr, wgt, *, gather, reduce):
    """Lane ``l``'s ``(messages (R, W), live (R, W))`` over a PAD-padded
    block read out of the pre-pass's tables, as the main kernels read
    them: a slot is live when its id is a vertex and (with ``bits``) lane
    l's frontier bit is set; its message is the table's entry, the
    weighted gathers then applying the slot's weight.  A dead slot holds
    the reduce identity."""
    valid = nbr != G.PAD
    safe = torch.where(valid, nbr, 0).long()
    live = valid
    if bits is not None:
        at = safe * K + l
        word = bits.to(torch.int64)[at // 32] & 0xFFFFFFFF
        live = live & (((word >> (at % 32)) & 1) != 0)
    m = msg[safe * K + l]
    if gather in ("add_w", "mul_w"):
        m = tref.gather_msg(gather, m, wgt.to(m.dtype), None)
    return torch.where(live, m, tref._identity(reduce, m.dtype)), live


def _lane_tables(values, degrees, active, lanes, *, gather, mask_inactive):
    """Per listed lane, ``(bits, msg, K, l)``: its launch's tables, their
    width and its place in them."""
    out = []
    for lo, _, k, K in tlanes.lane_chunks(lanes):
        bits, msg = _pack(values, degrees, active, lanes[lo:lo + k], K,
                          gather=gather, mask_inactive=mask_inactive)
        out += [(bits, msg, K, l) for l in range(k)]
    return out


def _keys(x):
    if x.dtype != np.float32:
        return x.astype(np.int64)
    i = x.view(np.int32).astype(np.int64)
    return np.where(i >= 0, i, i ^ 0x7FFFFFFF)


def _from_keys(k, dtype):
    if dtype != np.float32:
        return k.astype(dtype)
    return np.where(k >= 0, k, k ^ 0x7FFFFFFF).astype(np.int32).view(
        np.float32)


def _combine(a, b, reduce):
    """gather_ops.cuh's combine, elementwise: int add wraps, min/max
    propagate NaN and settle a +0/-0 tie as -0 < +0."""
    if reduce == "add":
        s = a.astype(np.int64) + b.astype(np.int64)
        return ((s + 2**31) % 2**32 - 2**31).astype(a.dtype)
    ufunc = np.minimum if reduce == "min" else np.maximum
    out = _from_keys(ufunc(_keys(a), _keys(b)), a.dtype)
    if a.dtype == np.float32:
        out = np.where(np.isnan(a) | np.isnan(b), np.float32(np.nan), out)
    return out


def _combine_runs(acc, starts, reduce):
    if reduce == "add":
        s = np.add.reduceat(acc.astype(np.int64), starts, axis=1)
        return ((s + 2**31) % 2**32 - 2**31).astype(acc.dtype)
    ufunc = np.minimum if reduce == "min" else np.maximum
    out = _from_keys(ufunc.reduceat(_keys(acc), starts, axis=1), acc.dtype)
    if acc.dtype == np.float32:
        nan = np.logical_or.reduceat(np.isnan(acc), starts, axis=1)
        out = np.where(nan, np.float32(np.nan), out)
    return out


def _fold_accumulate_decomposed(views, values, degrees, active, lanes, *,
                                gather, reduce, mask_inactive, order_seed):
    """``edge_block_fold_kernel`` in accumulate mode, one launch a view
    (pad rows included), in view order: per row each lane's partial (read
    from the pre-pass's tables), runs of equal owners folded a warp at a
    time, a whole run combined into the running table, a piece of a run
    crossing a warp or block edge combined by an atomic (the launch's
    atomics in a shuffled order), the identity writing nothing, ``got``
    set where a lane had a live slot."""
    kk, V = values.shape
    dtype = np.float32 if values.dtype.is_floating_point else np.int32
    ident = np.asarray(tref._identity(reduce, values.dtype), dtype)
    red = np.full((kk, V), ident, dtype)
    got = np.zeros((kk, V), bool)
    order = np.random.default_rng(order_seed)
    tables = _lane_tables(values, degrees, active, lanes, gather=gather,
                          mask_inactive=mask_inactive)
    for view in views:
        owner = view.owner8.numpy().astype(np.int64)
        R = owner.shape[0]
        if R == 0:
            continue
        t = np.arange(R)
        first = np.flatnonzero((t % 32 == 0)
                               | np.r_[True, owner[1:] != owner[:-1]])
        last = np.r_[first[1:], R] - 1
        o = owner[first]
        starts = (first % 32 != 0) | (first == 0) \
            | (owner[np.maximum(first - 1, 0)] != o)
        ends = (last % 32 != 31) | (last + 1 >= R) \
            | (owner[np.minimum(last + 1, R - 1)] != o)
        whole, piece = (o < V) & starts & ends, (o < V) & ~(starts & ends)
        parts = [_decode(*tab, view.flat_dst, view.flat_wgt, gather=gather,
                         reduce=reduce) for tab in tables]
        # each row's partial, a tie of +0 and -0 settled as the row's
        # combines in the kernel settle it
        acc = torch.stack([tref.settle_zero_ties(
            tref.row_reduce(reduce, p[0], 1),
            tref.zero_wins(p[0], reduce).any(1), reduce)
            for p in parts]).numpy()
        any_run = np.logical_or.reduceat(
            torch.stack([p[1].any(1) for p in parts]).numpy(), first, axis=1)
        run = _combine_runs(acc, first, reduce)
        writes = _keys(run) != _keys(np.broadcast_to(ident, run.shape))
        if dtype == np.float32:
            writes |= np.isnan(run)
        atomics = []
        for j, row in enumerate(lanes):
            np.logical_or.at(got[row], o[o < V], any_run[j, o < V])
            at = whole & writes[j]
            red[row, o[at]] = _combine(red[row, o[at]], run[j, at], reduce)
            atomics += [(row, int(v), x) for v, x in
                        zip(o[piece & writes[j]], run[j, piece & writes[j]])]
        for i in order.permutation(len(atomics)):
            row, v, x = atomics[i]
            red[row, v] = _combine(np.asarray([red[row, v]]),
                                   np.asarray([x]), reduce)[0]
    return torch.as_tensor(red), torch.as_tensor(got)


def _bits(t):
    a = t.numpy()
    if a.dtype != np.float32:
        return a
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


def _state(rng, kk, V, dtype, live=0.4):
    """int32 values near the wrap, or float32 with NaN and a third of +0
    and -0 (lanes of values >= 0 and lanes <= 0)."""
    if dtype == np.int32:
        vals = rng.integers(-50, 50, (kk, V)).astype(np.int32)
        vals[:, :3] = 2**31 - 1 - np.arange(3)
    else:
        vals = rng.uniform(0, 5, (kk, V)).astype(np.float32)
        zero = rng.random((kk, V)) < 0.33
        vals[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
        vals[1::2] *= -1
        vals[rng.random((kk, V)) < 0.03] = np.nan
    return torch.as_tensor(vals), torch.as_tensor(rng.random((kk, V)) < live)


def _jax_partial(entry, rows, vals, deg, act, lane, *, gather, reduce,
                 mask_inactive, plane):
    """The JAX package's streamed partial of one lane over one partition
    (``repro/core/stream.py``'s ``partial``): messages masked to the
    identity, ``jax.ops.segment_*`` by owner (pull) or destination (push),
    got = ``segment_max(live) > 0``."""
    V = vals.shape[1]
    key = np.asarray(entry["key"][:rows].numpy(), np.int32)
    slot = entry["slot"][:rows].numpy()
    slot = np.where(slot == G.PAD, V, slot)
    wgt = entry["wgt"][:rows].numpy()
    dtype = jnp.float32 if vals.dtype.is_floating_point else jnp.int32
    ident = rref._identity(reduce, dtype)
    v1 = jnp.concatenate([jnp.asarray(vals[lane].numpy()),
                          jnp.full((1,), ident, dtype)])
    a1 = jnp.concatenate([jnp.asarray(act[lane].numpy()),
                          jnp.zeros((1,), bool)])
    dpad = jnp.concatenate([jnp.asarray(deg.numpy()),
                            jnp.ones((1,), jnp.int32)])
    valid = slot < V
    if plane == "push":
        sv = jnp.broadcast_to(v1[key][:, None], slot.shape)
        sd = jnp.broadcast_to(dpad[key][:, None], slot.shape)
        sa = jnp.broadcast_to(a1[key][:, None], slot.shape)
        seg = jnp.asarray(slot)
    else:
        sv, sd, sa = v1[slot], dpad[slot], a1[slot]
        seg = jnp.broadcast_to(jnp.asarray(key)[:, None], slot.shape)
    live = valid & sa if mask_inactive else jnp.asarray(valid)
    msg = rref.gather_msg(gather, sv, jnp.asarray(wgt).astype(dtype), sd)
    msg = jnp.where(live, jnp.asarray(msg, dtype), ident)
    op = {"add": jax.ops.segment_sum, "min": jax.ops.segment_min,
          "max": jax.ops.segment_max}[reduce]
    red = op(msg.ravel(), seg.ravel(), num_segments=V + 1)
    got = jax.ops.segment_max(live.ravel().astype(jnp.int32), seg.ravel(),
                              num_segments=V + 1) > 0
    red = jnp.where(got, red, ident)
    return np.asarray(red)[:V], np.asarray(got)[:V]


def _same_value(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isnan(a) if a.dtype == np.float32
                                  else np.zeros(a.shape, bool),
                                  np.isnan(b) if b.dtype == np.float32
                                  else np.zeros(b.shape, bool))
    np.testing.assert_array_equal(np.nan_to_num(a), np.nan_to_num(b))


_CASES = [(g, r, d) for g in tref.GATHER_OPS for r in tref.REDUCE_OPS
          for d in (np.int32, np.float32)
          if not (g == "div_deg" and d == np.int32)
          and not (r == "add" and d == np.float32)]


@pytest.mark.parametrize("gather,reduce,dtype", _CASES)
def test_fold_accumulate_decomposition(gather, reduce, dtype):
    """The fold in accumulate mode over a store's pull partitions (padded
    entries included, so pad rows of owner V are swept) on one pre-pass:
    its decomposition equals the plain accumulate and the unprepared
    plain accumulate bit for bit, and the JAX package's per-partition
    segment reduce combined in partition order in value; k of 1, 8 and 33
    lanes (33: two launches), mask_inactive on and off."""
    g, store = _hub_store(2)
    V = g.num_vertices
    hub_rows = [int((store.pull_arrays(p)["key"] == 3).sum())
                for p in range(2)]
    assert max(hub_rows) > 256 and all(h > 0 for h in hub_rows)
    views = [_View(store.pull_arrays(p)) for p in range(2)]
    deg = g.out_degrees.to(torch.int32)
    rng = np.random.default_rng(len(gather) * 7 + len(reduce))
    for k in (1, 8, 33):
        kk = k + 2
        lanes = [int(i) for i in rng.permutation(kk)[:k]]
        vals, act = _state(rng, kk, V, dtype)
        for mask in (True, False):
            kw = dict(gather=gather, reduce=reduce, mask_inactive=mask)
            prep = teb.lanes_prepare(vals, deg, act, lanes, gather=gather,
                                     mask_inactive=mask)
            ident = tref._identity(reduce, vals.dtype)
            red = torch.full((kk, V), ident, dtype=vals.dtype)
            got = torch.zeros((kk, V), dtype=torch.bool)
            red2, got2 = red.clone(), got.clone()
            for view in views:
                teb.edge_block_fold_lanes(view, vals, deg, act, lanes,
                                          red=red, got=got, accumulate=True,
                                          prepared=prep, **kw)
                teb.edge_block_fold_lanes(view, vals, deg, act, lanes,
                                          red=red2, got=got2,
                                          accumulate=True, **kw)
            dred, dgot = _fold_accumulate_decomposed(
                views, vals, deg, act, lanes, order_seed=k, **kw)
            np.testing.assert_array_equal(_bits(red), _bits(red2))
            np.testing.assert_array_equal(_bits(red), _bits(dred))
            np.testing.assert_array_equal(got.numpy(), got2.numpy())
            np.testing.assert_array_equal(got.numpy(), dgot.numpy())
            for i in lanes[:3]:
                jred = jgot = None
                for p in range(2):
                    pr, pg = _jax_partial(
                        store.pull_arrays(p),
                        store.rows_per_partition["pull"][p], vals, deg, act,
                        i, plane="pull", **kw)
                    jred = pr if jred is None else np.asarray(
                        {"add": jnp.add, "min": jnp.minimum,
                         "max": jnp.maximum}[reduce](jred, pr))
                    jgot = pg if jgot is None else jgot | pg
                _same_value(red[i].numpy(), jred)
                np.testing.assert_array_equal(got[i].numpy(), jgot)
            rest = [i for i in range(kk) if i not in lanes]
            assert (red[rest] == ident).all() and not got[rest].any()


@pytest.mark.parametrize("K,k", [(1, 1), (4, 3), (8, 8), (32, 32)])
def test_prepass_tables_decode(K, k):
    """The pre-pass's tables: bit u K + l of the words is lane l's
    active[u] (pad lanes 0), entry u K + l of the messages lane l's
    message of u (the gather's for plus_one and div_deg, else the value);
    a PAD-padded block's slots read out of them as the main kernels read
    them give the plain gather's messages and liveness bit for bit."""
    rng = np.random.default_rng(K)
    V, kk = 70, k + 1
    rows = [int(i) for i in rng.permutation(kk)[:k]]
    vals = torch.as_tensor(rng.uniform(-4, 4, (kk, V)).astype(np.float32))
    act = torch.as_tensor(rng.random((kk, V)) < 0.5)
    deg = torch.as_tensor(rng.integers(0, 6, V).astype(np.int32))
    nbr = torch.as_tensor(rng.integers(0, V, (40, 8)).astype(np.int32))
    nbr[rng.random(nbr.shape) < 0.3] = G.PAD
    wgt = torch.as_tensor(rng.uniform(0.5, 4, nbr.shape).astype(np.float32))
    for gather in tref.GATHER_OPS:
        for mask in (True, False):
            bits, msg = _pack(vals, deg, act, rows, K, gather=gather,
                              mask_inactive=mask)
            for l, i in enumerate(rows):
                for reduce in ("min", "max"):
                    got = _decode(bits, msg, K, l, nbr, wgt, gather=gather,
                                  reduce=reduce)
                    want = tref.edge_block_messages(
                        nbr, wgt, vals[i], deg, act[i], gather=gather,
                        reduce=reduce, mask_inactive=mask)
                    np.testing.assert_array_equal(_bits(got[0]),
                                                  _bits(want[0]))
                    np.testing.assert_array_equal(got[1].numpy(),
                                                  want[1].numpy())
        bits, msg = _pack(vals, deg, act, rows, K, gather=gather,
                          mask_inactive=True)
        words = bits.numpy().view(np.uint32).astype(np.int64)
        at = np.arange(V * K)
        flags = ((words[at // 32] >> (at % 32)) & 1).reshape(V, K) != 0
        np.testing.assert_array_equal(flags[:, :k], act[rows].numpy().T)
        assert not flags[:, k:].any()
        table = msg.numpy().reshape(V, K)
        want = vals[rows].T
        if gather in ("plus_one", "div_deg"):
            want = tref.gather_msg(gather, want, torch.zeros_like(want),
                                   deg[:, None])
        np.testing.assert_array_equal(table[:, :k], want.numpy())
        assert (table[:, k:] == 0).all()


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_prepared_routes_equal_unprepared(dtype):
    """Every route called with a pre-pass's tables equals its call without
    bit for bit over each partition: kernel 1 (one lane,
    ``edge_block_prepare``), the lane kernel and the fold
    (``lanes_prepare``), the lane push (``push_lanes_prepare``), float add
    included; tables of other lanes are refused."""
    g, store = _hub_store(3)
    V = g.num_vertices
    deg = g.out_degrees.to(torch.int32)
    rng = np.random.default_rng(5)
    kk, lanes = 6, [4, 0, 2]
    vals, act = _state(rng, kk, V, dtype)
    for gather in tref.GATHER_OPS:
        if gather == "div_deg" and dtype == np.int32:
            continue
        for mask in (True, False):
            kw = dict(gather=gather, mask_inactive=mask)
            one = teb.edge_block_prepare(vals[lanes[0]], deg,
                                         act[lanes[0]], **kw)
            prep = teb.lanes_prepare(vals, deg, act, lanes, **kw)
            for p in range(3):
                e = store.pull_arrays(p)
                rows = store.rows_per_partition["pull"][p]
                blk = (e["slot"][:rows], e["wgt"][:rows])
                for reduce in tref.REDUCE_OPS:
                    a = teb.edge_block_reduce(*blk, vals[lanes[0]], deg,
                                              act[lanes[0]], reduce=reduce,
                                              prepared=one, **kw)
                    b = teb.edge_block_reduce(*blk, vals[lanes[0]], deg,
                                              act[lanes[0]], reduce=reduce,
                                              **kw)
                    np.testing.assert_array_equal(_bits(a[0]), _bits(b[0]))
                    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
                    a = teb.edge_block_reduce_lanes(
                        *blk, vals, deg, act, lanes, reduce=reduce,
                        prepared=prep, **kw)
                    b = teb.edge_block_reduce_lanes(
                        *blk, vals, deg, act, lanes, reduce=reduce, **kw)
                    np.testing.assert_array_equal(_bits(a[0]), _bits(b[0]))
                    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    with pytest.raises(ValueError, match="prepared"):
        teb.edge_block_fold_lanes(_View(store.pull_arrays(0)), vals, deg,
                                  act, [1, 2], gather="copy",
                                  reduce="min", red=vals.clone(),
                                  accumulate=True, need_got=False,
                                  prepared=teb.lanes_prepare(
                                      vals, deg, act, [2, 1],
                                      gather="copy"))


@pytest.mark.parametrize("gather,reduce,dtype", _CASES)
def test_push_partitions_got_matches_jax(gather, reduce, dtype):
    """The lane push over a store's push partitions into one running table
    with ``got`` and one pre-pass equals each lane's compacted push
    combined in partition order (bit for bit), and in value the JAX
    package's per-partition segment reduce, its got
    ``segment_max(live) > 0``."""
    g, store = _hub_store(3)
    V = g.num_vertices
    deg = g.out_degrees.to(torch.int32)
    rng = np.random.default_rng(len(gather) + 3 * len(reduce))
    kk, lanes = 5, [3, 1, 4]
    vals, act = _state(rng, kk, V, dtype, live=0.2)
    ident = tref._identity(reduce, vals.dtype)
    prep = tpe.push_lanes_prepare(act, lanes)
    table = torch.full((kk, V), ident, dtype=vals.dtype)
    got = torch.zeros((kk, V), dtype=torch.bool)
    table2, got2 = table.clone(), got.clone()
    kw = dict(gather=gather, reduce=reduce, identity=ident)
    for p in range(3):
        e = store.push_arrays(p)
        rows = store.rows_per_partition["push"][p]
        args = (e["key"][:rows], e["slot"][:rows], e["wgt"][:rows], vals,
                deg, act, lanes)
        tpe.push_ell_lanes_reduce(*args, num_rows=rows, table=table,
                                  got=got, prepared=prep, **kw)
        tpe.push_ell_lanes_reduce(*args, num_rows=rows, table=table2,
                                  got=got2, **kw)
    np.testing.assert_array_equal(_bits(table), _bits(table2))
    np.testing.assert_array_equal(got.numpy(), got2.numpy())
    for i in lanes:
        jred = jgot = None
        for p in range(3):
            pr, pg = _jax_partial(store.push_arrays(p),
                                  store.rows_per_partition["push"][p], vals,
                                  deg, act, i, gather=gather, reduce=reduce,
                                  mask_inactive=True, plane="push")
            jred = pr if jred is None else np.asarray(
                {"add": jnp.add, "min": jnp.minimum,
                 "max": jnp.maximum}[reduce](jred, pr))
            jgot = pg if jgot is None else jgot | pg
        _same_value(table[i].numpy(), jred)
        np.testing.assert_array_equal(got[i].numpy(), jgot)
