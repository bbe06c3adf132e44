"""Port parity: the fused lane sweep (``edge_block.edge_block_fold_lanes``,
``csrc/edge_block.cu``'s ``edge_block_fold_kernel``), on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it there
against its plain version); here its decomposition (per-sub-row partials,
runs of equal owners folded a warp at a time, whole segments stored, the
pieces of segments that cross warp and block edges combined in a shuffled
order as its atomics would) is held against the plain version, bit for
bit, and the JAX package's ``edge_block_reduce`` under ``jax.vmap`` with
its ``subrow_combine``, for min, max and int32 add, exactly.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.core import graph as RG
from repro.kernels import edge_block as reb
from repro.kernels import pull_bitmap as rpb

import torch
from repro_torch.core import graph as G
from repro_torch.kernels import edge_block as teb
from repro_torch.kernels import ref as tref
from torch_threads import one_thread  # noqa: F401


def _hub_plan_pair():
    """JAX and port flat pull views of one graph whose hub (vertex 3)
    receives 2,500 in-edges: bucketed at max_width 16, its in-row splits
    into 157 rows of 2 sub-rows, so its run of sub-rows crosses warp and
    256-thread block edges; other vertices split too."""
    rng = np.random.default_rng(21)
    V = 90
    src = np.concatenate([rng.integers(0, V, 900), rng.integers(0, V, 2500)])
    dst = np.concatenate([rng.integers(0, V, 900), np.full(2500, 3)])
    w = rng.uniform(0.5, 4.0, len(src)).astype(np.float32)
    rg = RG.from_edge_list(src, dst, weights=w, num_vertices=V)
    tg = G.from_edge_list(src, dst, weights=w, num_vertices=V)
    rp = RG.pull_bitmap_plan(RG.bucketize(RG.reverse(rg), max_width=16))
    tp = G.pull_bitmap_plan(G.bucketize(G.reverse(tg), max_width=16))
    return rg, tg, rp, tp


def _keys(x):
    """float32 -> int64 keys in the order -inf < ... < -0 < +0 < ... <
    +inf (NaN set apart by the caller); other dtypes as they are."""
    if x.dtype != np.float32:
        return x.astype(np.int64)
    i = x.view(np.int32).astype(np.int64)
    return np.where(i >= 0, i, i ^ 0x7FFFFFFF)


def _from_keys(k, dtype):
    if dtype != np.float32:
        return k.astype(dtype)
    return np.where(k >= 0, k, k ^ 0x7FFFFFFF).astype(np.int32).view(
        np.float32)


def _combine_runs(acc, starts, reduce):
    """Each lane's combine over runs of sub-rows beginning at ``starts``
    (the warp's segmented reduce): int add wraps; min and max propagate
    NaN and settle a +0/-0 tie in the order -0 < +0, as
    ``gather_ops.cuh``'s ``combine`` does."""
    if reduce == "add":
        s = np.add.reduceat(acc.astype(np.int64), starts, axis=1)
        return ((s + 2**31) % 2**32 - 2**31).astype(acc.dtype)
    ufunc = np.minimum if reduce == "min" else np.maximum
    out = _from_keys(ufunc.reduceat(_keys(acc), starts, axis=1), acc.dtype)
    if acc.dtype == np.float32:
        nan = np.logical_or.reduceat(np.isnan(acc), starts, axis=1)
        out = np.where(nan, np.float32(np.nan), out)
    return out


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


def _fold_decomposed(plan, values, degrees, active, lanes, *, gather,
                     reduce, mask_inactive, order_seed):
    """The fused lane sweep's decomposition (``edge_block_fold_kernel``):
    launches of at most 32 lanes; per sub-row each lane's partial and
    any-bit (its per-row stage, which
    ``test_torch_lanes.py::test_lane_kernel_decomposition_matches_plain``
    holds against kernel 1's plain version);
    per warp of 32 sub-rows each run of equal owners folded into its first
    thread; a run that is a whole segment stored plainly, any other piece
    of a segment (one that crosses a warp or a 256-thread block edge)
    combined into the identity-filled table as the kernel's atomics do,
    all pieces in a shuffled order; a lane whose combine is the identity
    writes nothing; got set for each lane with a live slot."""
    kk, V = values.shape
    dtype = np.float32 if values.dtype.is_floating_point else np.int32
    ident = np.asarray(tref._identity(reduce, values.dtype), dtype)
    owner = plan.owner8.numpy().astype(np.int64)
    R = owner.shape[0]
    t = np.arange(R)
    # the warps' runs of equal owners: first and last sub-row, owner
    first = np.flatnonzero((t % 32 == 0)
                           | np.r_[True, owner[1:] != owner[:-1]])
    last = np.r_[first[1:], R] - 1
    o = owner[first]
    starts = (first % 32 != 0) | (first == 0) | (owner[first - 1] != o)
    ends = (last % 32 != 31) | (last + 1 >= R) \
        | (owner[np.minimum(last + 1, R - 1)] != o)
    whole, piece = (o < V) & starts & ends, (o < V) & ~(starts & ends)
    red = np.full((kk, V), ident, dtype)
    got = np.zeros((kk, V), bool)
    atomics = []
    for lo in range(0, len(lanes), 32):
        chunk = lanes[lo:lo + 32]
        parts = [teb.edge_block_reduce_plain(
            plan.flat_dst, plan.flat_wgt, values[i], degrees, active[i],
            gather=gather, reduce=reduce, mask_inactive=mask_inactive)
            for i in chunk]
        acc = torch.stack([p[0] for p in parts]).numpy()
        any_run = np.logical_or.reduceat(
            torch.stack([p[1] for p in parts]).numpy(), first, axis=1)
        run = _combine_runs(acc, first, reduce)
        writes = _keys(run) != _keys(np.broadcast_to(ident, run.shape))
        if dtype == np.float32:
            writes |= np.isnan(run)
        for j, row in enumerate(chunk):
            np.logical_or.at(got[row], o[o < V], any_run[j, o < V])
            at = whole & writes[j]
            red[row, o[at]] = run[j, at]
            atomics += [(row, int(v), x) for v, x in
                        zip(o[piece & writes[j]], run[j, piece & writes[j]])]
    for i in np.random.default_rng(order_seed).permutation(len(atomics)):
        row, v, x = atomics[i]
        if reduce == "add":
            red[row, v] = (int(red[row, v]) + int(x) + 2**31) % 2**32 - 2**31
        elif _improves(red[row, v], x, reduce, dtype == np.float32):
            red[row, v] = x
    return torch.as_tensor(red), torch.as_tensor(got)


def _bits(t):
    """A table's bit patterns, every NaN as one pattern."""
    a = t.numpy()
    if a.dtype != np.float32:
        return a
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


_FOLD_CASES = [(g, r, d) for g in tref.GATHER_OPS for r in tref.REDUCE_OPS
               for d in (np.int32, np.float32)
               if not (g == "div_deg" and d == np.int32)
               and not (r == "add" and d == np.float32)]


@pytest.mark.parametrize("gather,reduce,dtype", _FOLD_CASES)
def test_lane_fold_decomposition_matches_plain_and_jax(gather, reduce,
                                                       dtype):
    """The fused lane sweep's algorithm (per-sub-row partials, runs of
    equal owners folded per warp, whole segments stored, pieces of
    segments that cross warp and block edges combined in a shuffled
    order) equals its plain version (the single-lane plain sweep and
    subrow_combine a lane, ties of +0 and -0 settled) bit for bit, and the
    JAX ``edge_block_reduce`` under ``jax.vmap`` followed by the JAX
    ``subrow_combine`` in value (JAX leaves the sign of a tied zero to its
    order): k of 1, 3, 8 and 33 lanes (33: two launches) listed out of
    order in a state with lanes left out, a hub whose sub-rows cross block
    edges, split hubs, NaN values, ties of +0 and -0 (float lanes of
    values >= 0 and lanes <= 0, a third of them zeros of either sign),
    mask_inactive on and off."""
    rg, tg, rp, tp = _hub_plan_pair()
    V = tg.num_vertices
    assert tp.num_dup > 0
    owner = tp.owner8.numpy()
    hub = np.flatnonzero(owner == 3)
    assert hub[0] // 256 != hub[-1] // 256        # crosses a block edge
    deg = np.asarray(rg.out_degrees).astype(np.int32)
    ident = tref._identity(reduce, torch.from_numpy(np.zeros(1, dtype))
                           .dtype)
    rng = np.random.default_rng(len(gather) * 7 + len(reduce))
    kk = 35                                  # the state; maps leave lanes out
    if dtype == np.int32:
        vals = rng.integers(-50, 50, (kk, V)).astype(np.int32)
    else:
        vals = rng.uniform(0, 5, (kk, V)).astype(np.float32)
        zero = rng.random((kk, V)) < 0.33
        vals[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
        vals[1::2] *= -1
        vals[rng.random((kk, V)) < 0.03] = np.nan
    act = rng.random((kk, V)) < 0.4
    t_vals, t_deg, t_act = (torch.as_tensor(a) for a in (vals, deg, act))
    zeros = 0
    for mask in (True, False):
        kw = dict(gather=gather, reduce=reduce, mask_inactive=mask)

        def reference(v, a, kw=kw):
            """Every lane of the state through the JAX kernel and
            combine, as one program."""
            sub, sub_any = jax.vmap(lambda v1, a1: reb.edge_block_reduce(
                jnp.asarray(tp.flat_dst.numpy()),
                jnp.asarray(tp.flat_wgt.numpy()), v1, jnp.asarray(deg), a1,
                **kw))(v, a)
            return (jax.vmap(lambda x: rpb.subrow_combine(
                x, rp, ident, reduce, jnp.dtype(dtype)))(sub),
                jax.vmap(lambda x: rpb.subrow_combine(
                    x.astype(jnp.int8), rp, 0, "max", jnp.int8))(sub_any))

        r_red, r_got = (np.asarray(x) for x in jax.jit(reference)(
            jnp.asarray(vals), jnp.asarray(act)))
        r_got = r_got != 0
        for k in (1, 3, 8, 33):
            lanes = [int(i) for i in rng.permutation(kk)[:k]]
            want, want_got = teb.edge_block_fold_lanes_plain(
                tp, t_vals, t_deg, t_act, lanes, **kw)
            got, got_got = teb.edge_block_fold_lanes(
                tp, t_vals, t_deg, t_act, lanes, **kw)
            emu, emu_got = _fold_decomposed(tp, t_vals, t_deg, t_act, lanes,
                                            **kw, order_seed=k)
            for red, g in ((got, got_got), (emu, emu_got)):
                np.testing.assert_array_equal(_bits(red), _bits(want))
                assert torch.equal(g, want_got)
            if dtype == np.float32:
                zeros += int((want == 0).sum())
            np.testing.assert_array_equal(r_red[lanes], want[lanes].numpy())
            np.testing.assert_array_equal(r_got[lanes],
                                          want_got[lanes].numpy())
            left_out = [i for i in range(kk) if i not in lanes]
            assert bool((want[left_out] == ident).all())
            assert not bool(want_got[left_out].any())
    if dtype == np.float32 and gather in ("copy", "mul_w", "div_deg"):
        assert zeros > 0       # min/max results that are a zero


def test_lane_fold_wrapper_on_cpu():
    """On CPU tensors the fused lane sweep is its plain version: a given
    table keeps the rows not listed; need_got=False drops the flags; a
    float add, repeated or out-of-range lanes and bad shapes raise; no
    launch is counted."""
    _, tg, _, tp = _hub_plan_pair()
    V = tg.num_vertices
    rng = np.random.default_rng(2)
    vals = torch.as_tensor(rng.integers(0, 9, (4, V)).astype(np.int32))
    act = torch.as_tensor(rng.random((4, V)) < 0.5)
    deg = torch.as_tensor(np.asarray(tg.out_degrees).astype(np.int32))
    kw = dict(gather="plus_one", reduce="min")
    red = torch.full((4, V), 7, dtype=torch.int32)
    red[2] = tref._identity("min", torch.int32)
    out, none = teb.edge_block_fold_lanes(tp, vals, deg, act, [2], red=red,
                                          need_got=False, **kw)
    assert none is None and out is red
    assert bool((out[[0, 1, 3]] == 7).all())
    want, _ = teb.edge_block_fold_lanes_plain(tp, vals, deg, act, [2], **kw)
    assert torch.equal(out[2], want[2])
    for bad in ([1, 1], [4], [-1]):
        with pytest.raises(ValueError, match="distinct rows"):
            teb.edge_block_fold_lanes(tp, vals, deg, act, bad, **kw)
    with pytest.raises(ValueError, match="order"):
        teb.edge_block_fold_lanes(tp, vals.float(), deg, act, [0],
                                  gather="copy", reduce="add")
    with pytest.raises(ValueError, match="want \\(k', V\\)"):
        teb.edge_block_fold_lanes(tp, vals[0], deg, act[0], [0], **kw)
    assert teb.edge_block_fold_lanes.launches == 0       # no card here
