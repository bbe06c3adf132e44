"""Port parity: the streamed float-add fold (``csrc/stream_fold.cu``,
``edge_block.edge_block_add_fold_lanes``), on the CPU.

The streamed engine's float-add pull partials go through one tiled
kernel.  It runs only on the card, where ``chip_smoke.py`` holds it
against its plain version and the route it replaced.  Here:

* the float-add wrapper's plain version (the CPU's route) equals the
  route it replaced, kernel 1's and kernel 4's plain versions and the
  add, bit for bit, over random partitions (1-5 partitions, owners split
  across them, 1, 3 and 8 lanes, got on and off);
* the kernel's decomposition, modelled here (tiles of threads x rows;
  each row in slot order from the identity, read from the pre-pass's
  tables as the kernel reads them; a thread's runs; the block-wide
  segmented scan as warp shuffles then warp totals; per-tile carries
  folded in tile order; each run's total combined into the running
  entry read before the rows, got stored a run of a thread), equals the
  replaced route modelled with the same scan (kernel 4 writing a (V,)
  partial, then ``red + partial``) bit for bit, writes each owner's entry
  at most once a launch, and agrees with the plain version within rtol
  1e-5 and with the JAX package's streamed partial
  (``jax.ops.segment_sum`` by owner over each partition, combined in
  partition order);
* streamed pagerank, a float add with a ``changed`` frontier (so ``got``
  is kept) and a multi-lane ``run_batch`` of ppr against the JAX
  streamed engine within rtol 1e-5, iterations and every counter exact.
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.core import dsl as RD
from repro.core import scheduler as RS
from repro.core.translator import translate as rtranslate

import torch
from repro_torch.core import dsl
from repro_torch.core import graph as G
from repro_torch.core import preprocess
from repro_torch.core.scheduler import DirectionPolicy, ScheduleConfig
from repro_torch.core.translator import translate
from repro_torch.kernels import edge_block as teb
from repro_torch.kernels import ref as tref
from test_torch_stream_kernels import (_View, _bits, _decode, _jax_partial,
                                       _lane_tables)
from torch_threads import one_thread  # noqa: F401


def _store(parts, V=300, E=4000, hub=6000, seed=21):
    """A partition store whose hub (vertex 3) receives ``hub`` in-edges,
    so its rows run across tiles and partitions; weighted."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, V, E), rng.integers(0, V, hub)])
    dst = np.concatenate([rng.integers(0, V, E), np.full(hub, 3)])
    w = rng.uniform(0.5, 4.0, len(src)).astype(np.float32)
    g = G.from_edge_list(src, dst, weights=w, num_vertices=V)
    cuts = G.edge_interval_cuts(g.out_degrees.numpy(), parts)
    return g, preprocess.PartitionStore(g, cuts)


def _views(store):
    return [_View(store.pull_arrays(p), store.rows_per_partition["pull"][p])
            for p in range(store.partitions)]


def _float_state(rng, kk, V, live=0.5):
    """float32 values with NaN and a fifth of +0 and -0; frontiers."""
    vals = rng.uniform(-5, 5, (kk, V)).astype(np.float32)
    zero = rng.random((kk, V)) < 0.2
    vals[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
    vals[rng.random((kk, V)) < 0.02] = np.nan
    return torch.as_tensor(vals), torch.as_tensor(rng.random((kk, V)) < live)


def _replaced_route_plain(view, vals, deg, act, lanes, *, gather,
                          mask_inactive, red, got):
    """The float-add route before the fused fold, on plain versions: the
    row sums (one lane: kernel 1's plain version; several: the lane
    kernel's), kernel 4's plain version by owner, the add; got by a
    segment max of the rows' any-live flags."""
    V = vals.shape[1]
    kw = dict(gather=gather, reduce="add", mask_inactive=mask_inactive)
    if len(lanes) == 1:
        s, a = teb.edge_block_reduce_plain(view.flat_dst, view.flat_wgt,
                                           vals[lanes[0]], deg,
                                           act[lanes[0]], **kw)
        sums, anys = s[None], a[None]
    else:
        sums, anys = teb.edge_block_reduce_lanes_plain(
            view.flat_dst, view.flat_wgt, vals, deg, act, lanes, **kw)
    for j, i in enumerate(lanes):
        red[i] += tref.segment_reduce_ref(view.owner8, sums[j], V)
        if got is not None:
            got[i] |= tref.segment_reduce_ref(
                view.owner8, anys[j].to(torch.int32), V, reduce="max") > 0
    return red, got


@pytest.mark.parametrize("parts", [1, 2, 3, 5])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("with_got", [True, False])
def test_add_fold_plain_is_the_replaced_route(parts, k, with_got):
    """The fused float-add fold on the CPU (its plain version) equals the
    route it replaced, partition after partition into one running table,
    bit for bit; lanes left out of the map keep their rows."""
    g, store = _store(parts, seed=parts * 10 + k)
    V = g.num_vertices
    deg = g.out_degrees.to(torch.int32)
    rng = np.random.default_rng(parts * 100 + k)
    kk = k + 2
    lanes = [int(i) for i in rng.permutation(kk)[:k]]
    vals, act = _float_state(rng, kk, V)
    for gather in tref.GATHER_OPS:
        for mask in (True, False):
            kw = dict(gather=gather, mask_inactive=mask)
            red = torch.zeros((kk, V))
            got = torch.zeros((kk, V), dtype=torch.bool) if with_got \
                else None
            red2 = red.clone()
            got2 = None if got is None else got.clone()
            prep = teb.lanes_prepare(vals, deg, act, lanes, **kw)
            for view in _views(store):
                teb.edge_block_add_fold_lanes(view, vals, deg, act, lanes,
                                              red=red, got=got,
                                              prepared=prep, **kw)
                _replaced_route_plain(view, vals, deg, act, lanes, red=red2,
                                      got=got2, **kw)
            np.testing.assert_array_equal(_bits(red), _bits(red2))
            if with_got:
                np.testing.assert_array_equal(got.numpy(), got2.numpy())
                assert got.any()
            rest = [i for i in range(kk) if i not in lanes]
            assert (red[rest] == 0).all()


# ---------------------------------------------------------------------------
# the kernel's decomposition
# ---------------------------------------------------------------------------


def _add(a, b):
    """gather_ops.cuh's float add of two scalars, in float32."""
    return np.float32(np.float32(a) + np.float32(b))


def _row_sums(msg):
    """Each row's sum in slot order from +0 (kernel 1)."""
    acc = np.zeros(msg.shape[0], np.float32)
    for s in range(msg.shape[1]):
        acc = (acc + msg[:, s].astype(np.float32)).astype(np.float32)
    return acc


def _block_scan(f, a, comb, ident):
    """The tile's segmented scan as the kernel runs it: within each warp
    of 32 threads a shuffle scan (step o reads the values before the
    step), the warp totals folded in warp order into each later warp, then
    shifted by one thread.  Returns each thread's (ef, ea): a head seen
    before it in the tile, and the partial open at the end of the thread
    before it."""
    n = len(f)
    warp = min(32, n)
    f, a = list(f), list(a)

    def op(lf, la, rf, ra):
        return (lf or rf), (ra if rf else comb(la, ra))

    for w0 in range(0, n, warp):
        o = 1
        while o < warp:
            prev = [(f[t], a[t]) for t in range(w0, w0 + warp)]
            for t in range(w0 + o, w0 + warp):
                f[t], a[t] = op(*prev[t - w0 - o], f[t], a[t])
            o *= 2
    totals = [(f[w0 + warp - 1], a[w0 + warp - 1])
              for w0 in range(0, n, warp)]
    pre = [(False, ident)]
    for w in range(1, len(totals)):
        pf, pa = totals[0]
        for w2 in range(1, w):
            pf, pa = op(pf, pa, *totals[w2])
        pre.append((pf, pa))
    for t in range(warp, n):
        f[t], a[t] = op(*pre[t // warp], f[t], a[t])
    return [pre[t // warp] if t % warp == 0 else (f[t - 1], a[t - 1])
            for t in range(n)]


def _tiles(key, v, live, V, threads, items, sink, mark):
    """One launch of the tile kernel and its carry fold over a lane's row
    sums ``v`` (any-live flags ``live``) and owners ``key``: each
    finished run goes to ``sink(owner, total)``, each run of a thread
    with a live row to ``mark(owner)``."""
    n, tile = len(key), threads * items
    ident = np.float32(0)
    comb = _add
    cf, cl, flags = {}, {}, {}
    beyond = -2 if n and int(key[n - 1]) == -1 else -1
    for b in range(-(-n // tile)):
        base = b * tile
        tile_end = min(base + tile, n)
        last_i = tile_end - 1
        cont_prev = base > 0 and key[base - 1] == key[base]
        cont_next = tile_end < n and key[tile_end] == key[tile_end - 1]

        def finish(k_, agg, starts, ends):
            to_first, to_last = starts and cont_prev, ends and cont_next
            if to_first:
                cf[b] = agg
            if to_last:
                cl[b] = agg
            if not (to_first or to_last) and 0 <= k_ < V:
                sink(k_, agg)
            if ends:
                assert b not in flags, "a tile's flags written twice"
                flags[b] = (starts, cont_prev, cont_next)

        rows = [range(base + t * items, base + (t + 1) * items)
                for t in range(threads)]
        K = [[int(key[i]) if i < n else beyond for i in r] for r in rows]
        X = [[v[i] if i < n else ident for i in r] for r in rows]
        L = [[bool(live[i]) if i < n else False for i in r] for r in rows]
        local = []
        for t in range(threads):
            k, x, lv, i0 = K[t], X[t], L[t], base + t * items
            head_in, first_end, acc, first_agg = False, items - 1, x[0], None
            run_live = lv[0]
            for j in range(1, items):
                if k[j] != k[j - 1]:
                    if run_live and 0 <= k[j - 1] < V:
                        mark(k[j - 1])
                    if not head_in:
                        first_agg, first_end, head_in = acc, j - 1, True
                    else:
                        finish(k[j - 1], acc, False, i0 + j - 1 == last_i)
                    acc, run_live = x[j], lv[j]
                else:
                    acc, run_live = comb(acc, x[j]), run_live or lv[j]
            if run_live and 0 <= k[-1] < V:
                mark(k[-1])
            if not head_in:
                first_agg = acc
            head0 = t > 0 and k[0] != K[t - 1][-1]
            local.append((head_in, first_end, acc, first_agg, head0))
        scan = _block_scan([lo[0] or lo[4] for lo in local],
                           [lo[2] for lo in local], comb, ident)
        for t in range(threads):
            head_in, first_end, acc, first_agg, head0 = local[t]
            k, i0 = K[t], base + t * items
            if i0 >= n:
                continue
            ef, ea = scan[t]
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
    tiles = -(-n // tile)
    for b in range(tiles):
        single, cont_prev, cont_next = flags[b]
        if not cont_next or (single and cont_prev):
            continue
        k_ = int(key[(b + 1) * tile])
        if not 0 <= k_ < V:
            continue
        acc = cl[b]
        for j in range(b + 1, tiles):
            acc = comb(acc, cf[j])
            if not (flags[j][0] and flags[j][2]):
                break
        sink(k_, acc)


def _lane_rows(view, vals, deg, act, lanes, *, gather, mask_inactive):
    """Per listed lane, its rows' sums and any-live flags as the kernel
    computes them from the pre-pass's tables."""
    tables = _lane_tables(vals, deg, act, lanes, gather=gather,
                          mask_inactive=mask_inactive)
    out = []
    for bits, msg, K, l in tables:
        m, live = _decode(bits, msg, K, l, view.flat_dst, view.flat_wgt,
                          gather=gather, reduce="add")
        out.append((_row_sums(m.numpy()), live.any(1).numpy()))
    return out


def _stream_fold_modelled(view, vals, deg, act, lanes, *, gather,
                          mask_inactive, red, got, threads, items):
    """The kernel over one partition into the running numpy tables: each
    run's total added into its owner's entry, a total of +0 not added,
    got set a run of a thread."""
    key = view.owner8.numpy()
    V = vals.shape[1]
    rows = _lane_rows(view, vals, deg, act, lanes, gather=gather,
                      mask_inactive=mask_inactive)
    for i, (v, live) in zip(lanes, rows):
        written = set()

        def sink(o, total, i=i, written=written):
            assert o not in written, "an owner's entry written twice"
            written.add(o)
            if np.float32(total).view(np.int32) != 0:
                red[i, o] = _add(red[i, o], total)

        def mark(o, i=i):
            if got is not None:
                got[i, o] = True

        _tiles(key, v, live, V, threads, items, sink, mark)


def _replaced_route_modelled(view, vals, deg, act, lanes, *, gather,
                             mask_inactive, red, got, threads, items):
    """The route the fused fold replaced, with the same tiles and scan:
    kernel 4 writes each run's total into a (V,) partial of +0, which is
    then added to the whole running row; got from the rows' flags by
    owner."""
    key = view.owner8.numpy()
    V = vals.shape[1]
    rows = _lane_rows(view, vals, deg, act, lanes, gather=gather,
                      mask_inactive=mask_inactive)
    for i, (v, live) in zip(lanes, rows):
        part = np.zeros(V, np.float32)

        def sink(o, total, part=part):
            part[o] = total

        _tiles(key, v, np.zeros_like(live), V, threads, items, sink,
               lambda o: None)
        red[i] = (red[i] + part).astype(np.float32)
        if got is not None:
            ok = (key >= 0) & (key < V) & live
            got[i, key[ok]] = True


_TILE_SHAPES = ((2, 3), (4, 2), (64, 2), (256, 8))   # threads x rows


@pytest.mark.parametrize("threads,items", _TILE_SHAPES)
@pytest.mark.parametrize("parts", [2, 3])
def test_stream_fold_decomposition(threads, items, parts):
    """The fused float-add fold's decomposition over 2 and 3 pull
    partitions (a hub's rows across tiles and partitions, pad rows of
    owner V), one pre-pass, k of 1 and 8 lanes, mask_inactive on and off:
    each owner's entry written at most once a launch; equal to the
    replaced route modelled with the same tiles bit for bit, to the plain
    version within rtol 1e-5, and to the JAX package's streamed partials
    combined in partition order within rtol 1e-5, got exactly."""
    big = (threads, items) == (256, 8)
    g, store = _store(parts, V=2000 if big else 300,
                      E=40000 if big else 3000, hub=20000 if big else 1500,
                      seed=parts + threads)
    V = g.num_vertices
    deg = g.out_degrees.to(torch.int32)
    views = _views(store)
    rng = np.random.default_rng(threads * 7 + items + parts)
    for k in (1, 8):
        kk = k + 1
        lanes = [int(i) for i in rng.permutation(kk)[:k]]
        vals, act = _float_state(rng, kk, V)
        gather = ("div_deg", "add_w", "plus_one")[(parts + k) % 3]
        for mask in (True, False):
            kw = dict(gather=gather, mask_inactive=mask)
            red = np.zeros((kk, V), np.float32)
            got = np.zeros((kk, V), bool)
            ored, ogot = red.copy(), got.copy()
            tred = torch.zeros((kk, V))
            tgot = torch.zeros((kk, V), dtype=torch.bool)
            for view in views:
                _stream_fold_modelled(view, vals, deg, act, lanes, red=red,
                                      got=got, threads=threads, items=items,
                                      **kw)
                _replaced_route_modelled(view, vals, deg, act, lanes,
                                         red=ored, got=ogot,
                                         threads=threads, items=items, **kw)
                teb.edge_block_add_fold_lanes(view, vals, deg, act, lanes,
                                              red=tred, got=tgot, **kw)
            np.testing.assert_array_equal(_bits(torch.as_tensor(red)),
                                          _bits(torch.as_tensor(ored)))
            np.testing.assert_array_equal(got, ogot)
            np.testing.assert_array_equal(got, tgot.numpy())
            np.testing.assert_allclose(red, tred.numpy(), rtol=1e-5,
                                       atol=1e-5)
            for i in lanes[:2]:
                jred = jgot = None
                for p in range(parts):
                    pr, pg = _jax_partial(
                        store.pull_arrays(p),
                        store.rows_per_partition["pull"][p], vals, deg, act,
                        i, plane="pull", reduce="add", **kw)
                    jred = pr if jred is None else np.asarray(
                        jnp.add(jred, pr))
                    jgot = pg if jgot is None else jgot | pg
                np.testing.assert_array_equal(got[i], jgot)
                np.testing.assert_allclose(red[i], jred, rtol=1e-5,
                                           atol=1e-5)


# ---------------------------------------------------------------------------
# the streamed engine's float add against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graph():
    src, dst = G.rmat_edges(1500, 12000, seed=5)
    from repro.core import graph as RG
    return (RG.from_edge_list(src, dst, num_vertices=1500),
            G.from_edge_list(src, dst, num_vertices=1500))


def _counters(stats):
    times = ("partition_transfer_s", "partition_compute_s",
             "partition_wall_s", "overlap_efficiency", "checkpoint_write_s")
    out = {k: v for k, v in stats.items() if k not in times}
    out.pop("partition_store", None)
    return out


def _cfgs(parts):
    return (RS.ScheduleConfig(partitions=parts,
                              direction=RS.DirectionPolicy(mode="pull")),
            ScheduleConfig(partitions=parts,
                           direction=DirectionPolicy(mode="pull")))


def _changed_pagerank(pkg, iters=8):
    """Pagerank with a ``changed`` frontier: a float add that keeps
    ``got`` (inactive sources masked)."""
    return dataclasses.replace(pkg.pagerank_program(iters=iters),
                               name="pagerank_changed", frontier="changed",
                               mask_inactive=True)


@pytest.mark.parametrize("parts", [1, 2, 3, 5])
@pytest.mark.parametrize("program", ["pagerank", "pagerank_changed"])
def test_streamed_float_add_matches_jax(graph, parts, program, tmp_path):
    """Streamed pagerank (and its ``changed``-frontier variant, whose
    partials keep got) through the fused float-add fold: within rtol 1e-5
    of the JAX streamed engine, iterations and every counter equal, and
    bitwise equal across two runs; one partition streams from a
    container of each package."""
    from repro.data import graphs as RDATA
    from repro_torch.data import graphs as D
    rg, tg = graph
    rcfg, tcfg = _cfgs(parts)
    if parts == 1:
        rg = RDATA.load_partition_container(RDATA.container_from_graph(
            str(tmp_path / "r.npz"), rg, 1))
        tg = D.load_partition_container(D.container_from_graph(
            str(tmp_path / "t.npz"), tg, 1))
    if program == "pagerank":
        rprog, tprog = RD.pagerank_program(iters=8), \
            dsl.pagerank_program(iters=8)
    else:
        rprog, tprog = _changed_pagerank(RD), _changed_pagerank(dsl)
    rp = rtranslate(rprog, rg, rcfg)
    tp = translate(tprog, tg, tcfg, device="cpu")
    assert tp._float_add and not tp._general
    assert tp._need_got == (program == "pagerank_changed")
    rv, rit = rp.run(roots=0)
    tv, tit = tp.run(roots=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=1e-5,
                               atol=1e-7)
    assert int(rit) == tit
    assert _counters(rp.last_run_stats) == _counters(tp.last_run_stats)
    tv2, _ = tp.run(roots=0)
    np.testing.assert_array_equal(_bits(tv), _bits(tv2))


@pytest.mark.parametrize("roots", [[250, 3, 7], [250, 0, 5, 17, 99, 3, 42,
                                                   1200]])
def test_streamed_ppr_run_batch_matches_jax(graph, roots):
    """ppr through ``run_batch`` over 3 and 8 lanes on 3 partitions (the
    fused fold at K = 4 and 8): within rtol 1e-5 of the JAX streamed
    engine's batch, iterations and every counter equal, and each lane
    bitwise equal to the port's own streamed sequential run."""
    rg, tg = graph
    rcfg, tcfg = _cfgs(3)
    rp = rtranslate(RD.ppr_program(250), rg, rcfg)
    tp = translate(dsl.ppr_program(250), tg, tcfg, device="cpu")
    rv, ri = rp.run_batch(np.asarray(roots))
    tv, ti = tp.run_batch(roots)
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(np.asarray(ri), ti.numpy())
    assert _counters(rp.last_run_stats) == _counters(tp.last_run_stats)
    for i, r in enumerate(roots):
        v, it = tp.run(roots=r)
        np.testing.assert_array_equal(_bits(tv[i]), _bits(v))
        assert int(ti[i]) == it
