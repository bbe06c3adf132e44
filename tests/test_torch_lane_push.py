"""Port parity: the lane push (``push_ell.push_ell_lanes_reduce``,
``csrc/push_ell.cu``'s ``push_ell_lanes_kernel``), on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it there
against its plain version); here its decomposition (the pushing lanes'
frontier bits packed K a vertex, then per forward-ELL row its source's
lane bits, nothing for a row with no live lane, and for each live lane
and each slot whose id is a vertex one message combined into the lane's
table, its got byte set by an OR, all in a shuffled order as its atomics
would; and the scan's per-warp queue of live rows pass by pass) is held
against each lane's compacted push (the port's and the JAX package's
``push_ell_reduce`` under ``jax.vmap``, its Pallas message stage in
interpret mode) and the wrapper's plain version, bit for bit.
"""
from functools import partial

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.kernels import ops as rops

import torch
from repro_torch.kernels import lanes as tlanes
from repro_torch.kernels import push_ell as tpe
from repro_torch.kernels import ref as tref
from torch_threads import one_thread  # noqa: F401

PAD = 2**31 - 1
STATE_LANES = 35


def _forward_ell(rng, V, R, W):
    """A forward ELL: sources sorted, a hub destination (vertex 7), rows
    wholly PAD and rows mostly PAD."""
    row_src = np.sort(rng.integers(0, V, R)).astype(np.int32)
    dst = rng.integers(0, V, (R, W)).astype(np.int32)
    dst[rng.random((R, W)) < 0.3] = 7
    dst[rng.random((R, W)) < 0.2] = PAD
    dst[:4] = PAD                                  # all-PAD rows
    heavy = rng.random(R) < 0.25                   # PAD-heavy rows
    dst[heavy] = np.where(rng.random((int(heavy.sum()), W)) < 0.85, PAD,
                          dst[heavy])
    wgt = rng.uniform(0.5, 4.0, (R, W)).astype(np.float32)
    return row_src, dst, wgt


def _state(rng, V, dtype):
    """A (35, V) state: values with NaN and ties of +0 and -0 (float:
    lanes of values >= 0 and lanes <= 0, a third of them zeros of either
    sign) or an add that wraps (int32); sparse frontiers (most rows have
    no live lane), one lane empty and one full."""
    if dtype == np.int32:
        vals = rng.integers(-50, 50, (STATE_LANES, V)).astype(np.int32)
        vals[:, :3] = 2**31 - 1 - np.arange(3)
    else:
        vals = rng.uniform(0, 5, (STATE_LANES, V)).astype(np.float32)
        zero = rng.random((STATE_LANES, V)) < 0.33
        vals[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
        vals[1::2] *= -1
        vals[rng.random((STATE_LANES, V)) < 0.05] = np.nan
    act = rng.random((STATE_LANES, V)) < 0.08
    act[0] = False
    act[1] = True
    return vals, act


def _improves(cur, m, reduce, is_float):
    """gather_ops.cuh's atomic_combine test: NaN beats a number, nothing
    beats NaN, a min takes -0 over +0 and a max +0 over -0."""
    if is_float:
        if cur != cur:
            return False
        if m != m:
            return True
        if m == cur:
            neg = bool(np.signbit(m)) and not bool(np.signbit(cur))
            pos = bool(np.signbit(cur)) and not bool(np.signbit(m))
            return neg if reduce == "min" else pos
    return m < cur if reduce == "min" else m > cur


def _bits(t):
    """A table's bit patterns, every NaN as one pattern."""
    a = t.numpy()
    if a.dtype != np.float32:
        return a
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


def _lane_push_decomposed(row_src, ell_dst, ell_wgt, values, degrees, active,
                          lanes, *, num_rows, gather, reduce, order_seed):
    """The lane push's algorithm.  Per launch of at most 32 lanes, the
    pre-pass packs each vertex's K lane bits into 32-bit words (32 / K
    vertices a word); per row below ``num_rows``, one word read for its
    source; a row with no live lane does nothing; else for each live lane
    its source value, the menu gather, and each slot whose id is a vertex
    one message.  The messages are combined into the identity-filled
    ``(k', V)`` table in a shuffled order, as the atomics do (min/max
    replace only on an improvement, NaN over a number, -0 over +0 for a
    min and +0 over -0 for a max; int add wraps).  Returns the table and
    the rows visited with no live lane."""
    kk, V = values.shape
    is_float = values.dtype.is_floating_point
    dtype = np.float32 if is_float else np.int32
    table = np.full((kk, V), tref._identity(reduce, values.dtype), dtype)
    msgs, dead_rows = [], 0
    src = row_src.numpy()[:num_rows].astype(np.int64)
    dst = ell_dst.numpy()[:num_rows]
    wgt = ell_wgt[:num_rows]
    W = dst.shape[1]
    for lo in range(0, len(lanes), 32):
        chunk = lanes[lo:lo + 32]
        K = next(w for w in tlanes.LANE_WIDTHS if w >= len(chunk))
        per = 32 // K
        bits = np.zeros((V, K), np.int64)
        bits[:, :len(chunk)] = active[chunk].numpy().T
        vpad = -(-V // per) * per
        lane_bits = np.zeros((vpad, K), np.int64)
        lane_bits[:V] = bits
        shifts = (np.arange(vpad) % per)[:, None] * K + np.arange(K)[None]
        words = (lane_bits << shifts).reshape(-1, per * K).sum(1)
        # each row's source's K lane bits, from its word
        live = (words[src * K // 32] >> (src * K % 32)) & ((1 << K) - 1)
        dead_rows += int((live == 0).sum())
        for j, row in enumerate(chunk):
            rows = np.flatnonzero((live >> j) & 1)
            s = torch.as_tensor(src[rows])
            v = values[row][s][:, None].expand(-1, W)
            m = tref.gather_msg(gather, v, wgt[rows].to(v.dtype),
                                degrees[s][:, None].expand(-1, W)).numpy()
            slot = (dst[rows] >= 0) & (dst[rows] < V)
            msgs += [(row, int(u), x) for u, x in
                     zip(dst[rows][slot], m[slot].astype(dtype))]
    for i in np.random.default_rng(order_seed).permutation(len(msgs)):
        row, u, m = msgs[i]
        if reduce == "add":
            table[row, u] = (int(table[row, u]) + int(m) + 2**31) \
                % 2**32 - 2**31
        elif _improves(table[row, u], m, reduce, is_float):
            table[row, u] = m
    return torch.as_tensor(table), dead_rows


SCAN_ROWS = 8       # rows a thread in the kernel's scan (kScanRows)


def _lane_push_queued(row_src, ell_dst, ell_wgt, values, degrees, active,
                      lanes, *, num_rows, gather, reduce, threads, table,
                      got, order_seed):
    """The lane push as the kernel runs it, into ``table`` and ``got``
    (running partials and bits, updated in place).  Per launch of at most
    32 lanes: the pre-pass's K-bit words; the scan, a warp of ``threads``
    threads taking ``threads * SCAN_ROWS`` rows, thread t rows t,
    t + threads, ... of them, each row's source's K bits read from its
    word; the warp's queue of its live rows, in the order the ballots
    write it (a row slot j of every thread, then slot j + 1); the queue's
    rows pushed by the warp's threads.  The pushes of every warp run in a
    shuffled order, in waves of ``threads``: a wave's test reads of the
    table (a push's words of its slots whose ids are vertices) all come
    before its atomics, so a read may be stale.  An atomic combines its
    message (min/max only where the read and the word itself say it
    improves: NaN over a number, -0 over +0 for a min and +0 over -0 for
    a max; int add wraps, unread) and sets its got byte (an OR).  Returns
    the statistics: the queues' total length and the (row, lane)
    pushes."""
    kk, V = values.shape
    is_float = values.dtype.is_floating_point
    dtype = np.float32 if is_float else np.int32
    tab = table.numpy()
    got_np = got.numpy() if got is not None else None
    src = row_src.numpy()[:num_rows].astype(np.int64)
    dst = ell_dst.numpy()[:num_rows]
    wgt = ell_wgt[:num_rows]
    W = dst.shape[1]
    rng = np.random.default_rng(order_seed)
    stats = {"queued": 0, "pushes": set()}
    msgs = {}                   # a lane's messages, every row's slots
    window = threads * SCAN_ROWS

    def message(row, lane):
        if lane not in msgs:
            s = torch.as_tensor(src)
            v = values[lane][s][:, None].expand(-1, W)
            msgs[lane] = tref.gather_msg(
                gather, v, wgt.to(v.dtype),
                degrees[s][:, None].expand(-1, W)).numpy().astype(dtype)
        return msgs[lane][row]

    for lo in range(0, len(lanes), 32):
        chunk = lanes[lo:lo + 32]
        K = next(w for w in tlanes.LANE_WIDTHS if w >= len(chunk))
        per = 32 // K
        bits = np.zeros((V, K), np.int64)
        bits[:, :len(chunk)] = active[chunk].numpy().T
        vpad = -(-V // per) * per
        lane_bits = np.zeros((vpad, K), np.int64)
        lane_bits[:V] = bits
        shifts = (np.arange(vpad) % per)[:, None] * K + np.arange(K)[None]
        words = (lane_bits << shifts).reshape(-1, per * K).sum(1)
        pushes = []
        for r0 in range(0, num_rows, window):
            queue = []
            for j in range(SCAN_ROWS):
                for t in range(threads):
                    r = r0 + t + threads * j
                    if r >= num_rows:
                        continue
                    s = int(src[r])
                    live = int((words[s * K // 32] >> (s * K % 32))
                               & ((1 << K) - 1))
                    if live:
                        queue.append((r, live))
            rows = range(r0, min(r0 + window, num_rows))
            assert sorted(r for r, _ in queue) == [
                r for r in rows
                if any(active[c][src[r]] for c in chunk)]
            stats["queued"] += len(queue)
            pushes += [(r, chunk[j]) for r, m in queue
                       for j in range(len(chunk)) if m >> j & 1]
        order = rng.permutation(len(pushes))
        for w0 in range(0, len(order), threads):
            wave = [pushes[i] for i in order[w0:w0 + threads]]
            reads = []
            for row, lane in wave:
                assert (row, lane) not in stats["pushes"]  # exactly once
                stats["pushes"].add((row, lane))
                ids = dst[row]
                reads.append([(int(ids[i]), message(row, lane)[i],
                               tab[lane, ids[i]]) for i in range(W)
                              if 0 <= ids[i] < V])      # the test reads
            for (row, lane), sent in zip(wave, reads):
                for u, x, cur in sent:
                    if reduce == "add":
                        tab[lane, u] = (int(tab[lane, u]) + int(x)
                                        + 2**31) % 2**32 - 2**31
                    elif _improves(cur, x, reduce, is_float) \
                            and _improves(tab[lane, u], x, reduce,
                                          is_float):
                        tab[lane, u] = x
                    if got_np is not None:
                        got_np[lane, u] = True
    return stats


_PUSH_CASES = [(g, r, d) for g in tref.GATHER_OPS for r in tref.REDUCE_OPS
               for d in (np.int32, np.float32)
               if not (g == "div_deg" and d == np.int32)
               and not (r == "add" and d == np.float32)]


@pytest.mark.parametrize("gather,reduce,dtype", _PUSH_CASES)
def test_lane_push_decomposition_matches_compacted_push_and_jax(
        gather, reduce, dtype):
    """The lane push's row scan and combine equals each lane's compacted
    push (the port's plain ``push_ell_reduce`` and the JAX package's under
    ``jax.vmap`` with its Pallas message stage) and the wrapper's plain
    version, bit for bit (the JAX push in value: it leaves the sign of a
    tied zero to its order): k of 1, 3, 8 and 33 lanes (33: two launches)
    listed out of order in a 35-lane state, rows with no live lane,
    all-PAD and PAD-heavy rows, rows past ``num_rows`` never read, a hub
    destination, NaN and ties of +0 and -0, an int add that wraps."""
    rng = np.random.default_rng(len(gather) * 11 + len(reduce))
    V, R, W = 60, 150, 8
    num_rows = R - 6
    row_src, dst, wgt = _forward_ell(rng, V, R, W)
    deg = rng.integers(0, 9, V).astype(np.int32)
    vals, act = _state(rng, V, dtype)
    t_src, t_dst, t_wgt, t_vals, t_deg, t_act = (
        torch.as_tensor(a) for a in (row_src, dst, wgt, vals, deg, act))
    ident = tref._identity(reduce, t_vals.dtype)
    # every lane of the state through the JAX compacted push
    r_red, _ = jax.vmap(lambda v, a: rops.push_ell_reduce(
        jnp.asarray(row_src), jnp.asarray(dst), jnp.asarray(wgt), v,
        jnp.asarray(deg), a, num_rows=num_rows, capacity=R, gather=gather,
        reduce=reduce, use_pallas=True, emit_touched=False))(
        jnp.asarray(vals), jnp.asarray(act))
    r_red = np.asarray(r_red)
    for k in (1, 3, 8, 33):
        lanes = [int(i) for i in rng.permutation(STATE_LANES)[:k]]
        kw = dict(num_rows=num_rows, gather=gather, reduce=reduce,
                  identity=ident)
        got = tpe.push_ell_lanes_reduce(t_src, t_dst, t_wgt, t_vals, t_deg,
                                        t_act, lanes, **kw)
        want = tpe.push_ell_lanes_reduce_plain(t_src, t_dst, t_wgt, t_vals,
                                               t_deg, t_act, lanes, **kw)
        emu, dead = _lane_push_decomposed(
            t_src, t_dst, t_wgt, t_vals, t_deg, t_act, lanes,
            num_rows=num_rows, gather=gather, reduce=reduce, order_seed=k)
        assert dead > 0 or 1 in lanes      # rows no lane pushes (lane 1: all)
        for out in (got, emu):
            np.testing.assert_array_equal(_bits(out), _bits(want))
        np.testing.assert_array_equal(r_red[lanes], want[lanes].numpy())
        for i in lanes:
            one, _ = tpe.push_ell_reduce(
                t_src, t_dst, t_wgt, t_vals[i], t_deg, t_act[i],
                num_rows=num_rows, capacity=R,
                gather_fn=partial(tref.gather_msg, gather), reduce=reduce,
                identity=ident, num_vertices=V, dtype=t_vals.dtype)
            np.testing.assert_array_equal(_bits(want[i]), _bits(one))
        left_out = [i for i in range(STATE_LANES) if i not in lanes]
        assert bool((want[left_out] == ident).all())


def _partials(rng, vals, reduce):
    """Running partials of a (35, V) table (the streamed engine's earlier
    partitions, or another push's): the identity in about half the
    entries, else a value of the state's kind; and a got table with a
    quarter of its bits set."""
    ident = tref._identity(reduce, vals.dtype)
    table = vals.clone()[torch.as_tensor(
        rng.permutation(STATE_LANES))].contiguous()
    table[torch.as_tensor(rng.random(tuple(vals.shape)) < 0.5)] = ident
    got = torch.as_tensor(rng.random(tuple(vals.shape)) < 0.25)
    return table, got


def _jax_lanes(row_src, dst, wgt, vals, deg, act, *, num_rows, gather,
               reduce):
    """Every lane of the state through the JAX compacted push under
    ``jax.vmap`` (Pallas in interpret mode): (red, touched)."""
    R = dst.shape[0]
    red, touched = jax.vmap(lambda v, a: rops.push_ell_reduce(
        jnp.asarray(row_src), jnp.asarray(dst), jnp.asarray(wgt), v,
        jnp.asarray(deg), a, num_rows=num_rows, capacity=R, gather=gather,
        reduce=reduce, use_pallas=True, emit_touched=True))(
        jnp.asarray(vals), jnp.asarray(act))
    return np.asarray(red), np.asarray(touched)


def _combined(partial, red, reduce):
    """A partial and a push's reduce combined in value, as numpy does."""
    if reduce == "add":
        return (partial.astype(np.int64) + red).astype(np.int64) \
            .astype(np.uint32).view(np.int32)
    return (np.minimum if reduce == "min" else np.maximum)(partial, red)


@pytest.mark.parametrize("gather,reduce,dtype", _PUSH_CASES)
def test_lane_push_queued_decomposition_matches_plain_and_jax(
        gather, reduce, dtype):
    """The lane push as the kernel runs it (the scan's per-warp queues of
    live rows, the pushes in a shuffled order with stale test reads, got
    set by OR) into running partials and got bits equals the wrapper's
    plain version bit for bit and, in value, the partials combined with
    the JAX package's ``push_ell_reduce`` under ``jax.vmap`` and its
    touched bits OR-ed in: k of 1, 3, 8 and 33 lanes (33: two launches)
    listed out of order in a 35-lane state, warps of 1, 4 and 32 threads
    (one warp's window, or several), with and without got."""
    rng = np.random.default_rng(len(gather) * 13 + len(reduce) + 7)
    V, R, W = 60, 150, 8
    num_rows = R - 6
    row_src, dst, wgt = _forward_ell(rng, V, R, W)
    deg = rng.integers(0, 9, V).astype(np.int32)
    vals, act = _state(rng, V, dtype)
    t_src, t_dst, t_wgt, t_vals, t_deg, t_act = (
        torch.as_tensor(a) for a in (row_src, dst, wgt, vals, deg, act))
    ident = tref._identity(reduce, t_vals.dtype)
    j_red, j_touched = _jax_lanes(row_src, dst, wgt, vals, deg, act,
                                  num_rows=num_rows, gather=gather,
                                  reduce=reduce)
    part0, got0 = _partials(rng, t_vals, reduce)
    kw = dict(num_rows=num_rows, gather=gather, reduce=reduce)
    for k in (1, 3, 8, 33):
        lanes = [int(i) for i in rng.permutation(STATE_LANES)[:k]]
        for with_got in (True, False):
            want_got = got0.clone()
            want = tpe.push_ell_lanes_reduce_plain(
                t_src, t_dst, t_wgt, t_vals, t_deg, t_act, lanes,
                identity=ident, table=part0.clone(),
                got=want_got if with_got else None, **kw)
            for threads in (1, 4, 32):
                table = part0.clone()
                got = got0.clone() if with_got else None
                stats = _lane_push_queued(
                    t_src, t_dst, t_wgt, t_vals, t_deg, t_act, lanes,
                    threads=threads, table=table, got=got,
                    order_seed=100 * k + threads, **kw)
                assert len(stats["pushes"]) == sum(
                    int(t_act[i][t_src[:num_rows].long()].sum())
                    for i in lanes)
                np.testing.assert_array_equal(_bits(table), _bits(want))
                if with_got:
                    np.testing.assert_array_equal(got.numpy(),
                                                  want_got.numpy())
            for i in lanes:
                np.testing.assert_array_equal(
                    want[i].numpy(),
                    _combined(part0[i].numpy(), j_red[i], reduce))
            if with_got:
                np.testing.assert_array_equal(
                    want_got[lanes].numpy(), got0[lanes].numpy()
                    | j_touched[lanes])
            rest = [i for i in range(STATE_LANES) if i not in lanes]
            assert torch.equal(_bits_t(want[rest]), _bits_t(part0[rest]))


def _bits_t(t):
    return torch.as_tensor(_bits(t))


def test_lane_push_wrapper_on_cpu():
    """On CPU tensors the lane push is its plain version: a given table
    keeps the rows not listed; num_rows = 0 pushes nothing; a float add,
    a non-menu gather, repeated or out-of-range lanes raise; no launch is
    counted."""
    rng = np.random.default_rng(5)
    V, R, W = 40, 60, 8
    row_src, dst, wgt = _forward_ell(rng, V, R, W)
    vals, act = _state(rng, V, np.int32)
    args = [torch.as_tensor(a) for a in (row_src, dst, wgt, vals,
                                         rng.integers(0, 5, V)
                                         .astype(np.int32), act)]
    ident = tref._identity("min", torch.int32)
    kw = dict(gather="plus_one", reduce="min", identity=ident)
    table = torch.full((STATE_LANES, V), 9, dtype=torch.int32)
    table[[4, 6]] = ident
    out = tpe.push_ell_lanes_reduce(*args, [6, 4], num_rows=R, table=table,
                                    **kw)
    assert out is table
    keep = [i for i in range(STATE_LANES) if i not in (4, 6)]
    assert bool((out[keep] == 9).all())
    want = tpe.push_ell_lanes_reduce_plain(*args, [4, 6], num_rows=R, **kw)
    assert torch.equal(out[[4, 6]], want[[4, 6]])
    empty = tpe.push_ell_lanes_reduce(*args, [1], num_rows=0, **kw)
    assert bool((empty == ident).all())
    for bad in ([2, 2], [STATE_LANES], [-1]):
        with pytest.raises(ValueError, match="distinct rows"):
            tpe.push_ell_lanes_reduce(*args, bad, num_rows=R, **kw)
    fargs = args[:3] + [args[3].float()] + args[4:]
    with pytest.raises(ValueError, match="float add"):
        tpe.push_ell_lanes_reduce(*fargs, [0], num_rows=R, gather="copy",
                                  reduce="add", identity=0.0)
    with pytest.raises(ValueError, match="not a menu"):
        tpe.push_ell_lanes_reduce(*args, [0], num_rows=R, gather="square",
                                  reduce="min", identity=ident)
    assert tpe.push_ell_lanes_reduce.launches == 0       # no card here
