"""Port parity: the sparse backend against the JAX package on the CPU.

The sparse pull plane (a chunk-streamed scatter over the reverse COO) and
its ``coo_chunks`` push twin: bfs, sssp and wcc under pull, push and auto
are bit-exact in values, ``iters`` and every ``run_stats`` field;
pagerank, spmv and in_degrees agree within ``rtol=1e-5`` (float sums
fold in another order: each chunk through kernel 4's plain version).  A graph of average degree below 4 plans the
sparse backend under ``backend='auto'``, as in the JAX package.
"""
import numpy as np
import pytest

import jax.numpy as jnp
from repro.core import algorithms as RALG
from repro.core import graph as RG

import torch
from repro_torch.core import algorithms as TALG
from repro_torch.core import dsl as TD
from repro_torch.core import graph as G
from repro_torch.core import preprocess as TP
from repro_torch.core import scheduler as TS
from repro_torch.core import translator as TT
from torch_stats import jax_stats
from torch_threads import one_thread  # noqa: F401

FLAVOR = {"sparse_xla": "sparse_torch"}


def _pair(V, E, seed):
    src, dst = RG.rmat_edges(V, E, seed=seed)
    w = np.random.default_rng(seed + 7).uniform(0.5, 4.0, len(src)) \
        .astype(np.float32)
    return (RG.from_edge_list(src, dst, num_vertices=V, weights=w),
            G.from_edge_list(src, dst, num_vertices=V, weights=w))


@pytest.fixture(scope="module")
def graphs():
    return _pair(1500, 12000, 0)


def _eq(ref, port):
    a, b = np.asarray(ref), port.numpy()
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("algo", ["bfs", "sssp", "wcc"])
@pytest.mark.parametrize("direction", ["pull", "push", "auto"])
def test_sparse_runs_bit_exact(graphs, algo, direction):
    rg, tg = graphs
    kw = dict(backend="sparse", direction=direction)
    if algo == "wcc":
        rv, ri, rrep = RALG.wcc(rg, **kw)
        tv, ti, trep = TALG.wcc(tg, device="cpu", **kw)
    else:
        rv, ri, rrep = getattr(RALG, algo)(rg, 3, **kw)
        tv, ti, trep = getattr(TALG, algo)(tg, 3, device="cpu", **kw)
    _eq(rv, tv)
    assert int(ri) == ti
    assert rrep.run_stats == jax_stats(trep.run_stats)
    assert FLAVOR[rrep.backend] == trep.backend == "sparse_torch"
    assert trep.push_layout == rrep.push_layout == \
        (None if direction == "pull" else "coo_chunks")
    assert trep.pipelines == rrep.pipelines


def test_sparse_push_counts_as_compacted(graphs):
    _, tg = graphs
    _, it, rep = TALG.bfs(tg, 3, backend="sparse", direction="push",
                          device="cpu")
    s = rep.run_stats
    assert s["push_supersteps"] == s["push_compacted_supersteps"] == it
    assert s["push_live_rows_per_pe"] == [0]


def test_sparse_float_adds_within_tolerance(graphs):
    rg, tg = graphs
    r, ri, _ = RALG.pagerank(rg, iters=10, backend="sparse")
    t, ti, rep = TALG.pagerank(tg, iters=10, backend="sparse", device="cpu")
    assert rep.backend == "sparse_torch" and int(ri) == ti
    np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-5)
    x = np.random.default_rng(4).uniform(-1, 1, tg.num_vertices) \
        .astype(np.float32)
    r, _ = RALG.spmv(rg, x, backend="sparse")
    t, _ = TALG.spmv(tg, x, backend="sparse", device="cpu")
    np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-5,
                               atol=1e-6)
    r = RALG.in_degrees(rg, backend="sparse")
    t = TALG.in_degrees(tg, backend="sparse", device="cpu")
    np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-5)
    np.testing.assert_array_equal(
        t.numpy(), np.bincount(tg.edges_dst.numpy(),
                               minlength=tg.num_vertices))


def test_sparse_float_add_folds_chunks_through_segment_reduce(graphs,
                                                             monkeypatch):
    """The sparse pull's float32 add folds each chunk (its receivers
    ascend) through kernel 4's wrapper, chunk by chunk, so the sum has no
    atomics on the card; the result agrees with the scatter form and the
    JAX package."""
    from repro_torch.kernels import push_scatter, segment_sum
    rg, tg = graphs
    lay = TP.layouts_for(tg)
    dst, src, wgt = lay.reverse_coo()
    assert bool((dst[1:] >= dst[:-1]).all())
    calls = []
    real = segment_sum.segment_reduce

    def counted(seg, val, n, *, reduce="add"):
        calls.append(seg.shape[0])
        return real(seg, val, n, reduce=reduce)

    monkeypatch.setattr(segment_sum, "segment_reduce", counted)
    V = tg.num_vertices
    cs = 1000
    chunks = [[a[s:s + cs] for s in range(0, dst.shape[0], cs)]
              for a in (dst, src, wgt)]
    values = torch.as_tensor(np.random.default_rng(1).uniform(
        0, 1, V).astype(np.float32))
    kw = dict(gather_fn=lambda v, w, d: v * w, reduce="add", identity=0.0,
              num_vertices=V, dtype=torch.float32)
    deg = tg.out_degrees
    act = torch.ones(V, dtype=torch.bool)
    folded, _ = push_scatter.push_scatter_reduce(
        *chunks, values, deg, act, sorted_dst=True, **kw)
    assert calls == [c.shape[0] for c in chunks[0]]
    scattered, _ = push_scatter.push_scatter_reduce(
        *chunks, values, deg, act, **kw)
    assert len(calls) == len(chunks[0])
    np.testing.assert_allclose(folded.numpy(), scattered.numpy(), rtol=1e-6,
                               atol=1e-6)
    calls.clear()
    r, _ = RALG.spmv(rg, values.numpy(), backend="sparse")
    t, _ = TALG.spmv(tg, values, backend="sparse", device="cpu")
    assert calls
    np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-5,
                               atol=1e-6)


def test_low_degree_graph_plans_sparse():
    rg, tg = _pair(2000, 5000, 3)          # average degree 2.5 < 4
    rv, ri, rrep = RALG.bfs(rg, 0)
    tv, ti, trep = TALG.bfs(tg, 0, device="cpu")
    assert trep.backend == "sparse_torch" == FLAVOR[rrep.backend]
    _eq(rv, tv)
    assert int(ri) == ti and rrep.run_stats == jax_stats(trep.run_stats)


def test_sparse_layouts_and_edgeless_graph():
    _, tg = _pair(300, 2400, 5)
    lay = TP.layouts_for(tg)
    seg, src, wgt = lay.reverse_coo()
    assert bool((seg[1:] >= seg[:-1]).all())          # sorted by receiver
    dst_c, src_c, _ = lay.forward_coo_chunks(8)
    assert dst_c.shape[0] == 8 and dst_c.numel() >= tg.num_edges
    assert lay.forward_coo_chunks(8) is lay.forward_coo_chunks(8)
    edgeless = G.from_edge_list(np.zeros(0, np.int32), np.zeros(0, np.int32),
                                num_vertices=5)
    prog = TT.translate(TD.bfs_program(), edgeless,
                        TS.ScheduleConfig(backend="sparse"), device="cpu")
    levels, it = prog.run(roots=2)
    assert it == 1 and int(levels[2]) == 0 and int(levels[0]) == 2**30
