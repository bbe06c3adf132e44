"""Port parity: the paper's atomic-operator layer (``core/operators.py``)
and the host preprocessing helpers (``partition_edges``, ``reorder``,
``layout``, ``write_values``) against the JAX package, on the CPU.

Seeded numpy inputs over R-MAT graphs, PAD ids included, go through both
packages' functions.  Every result is exact, but float add reductions
(``Reduce``/``Reduce_segment``/``Send`` with ``add``), held within
``rtol=1e-5``: the port scatters in ``scatter_reduce_``'s order.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.core import graph as RG
from repro.core import operators as RO
from repro.core import preprocess as RP

import torch
from repro_torch.core import graph as G
from repro_torch.core import operators as TO
from repro_torch.core import preprocess as TP

PAD = G.PAD
V, E = 300, 2400


@pytest.fixture(scope="module")
def graphs():
    src, dst = RG.rmat_edges(V, E, seed=5)
    rng = np.random.default_rng(5)
    w = rng.uniform(0.5, 2.0, len(src)).astype(np.float32)
    vals = rng.uniform(-4, 4, V).astype(np.float32)
    return (RG.from_edge_list(src, dst, num_vertices=V, weights=w,
                              vertex_values=vals),
            G.from_edge_list(src, dst, num_vertices=V, weights=w,
                             vertex_values=vals), src, dst, w)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _exact(t, r):
    t, r = _np(t), _np(r)
    assert t.dtype == r.dtype and t.shape == r.shape, (t.dtype, r.dtype)
    np.testing.assert_array_equal(t, r)


def _graph_fields(g):
    return [g.vertex_values, g.edge_offsets, g.edges_dst, g.edge_weights]


def test_registry_has_the_jax_keys():
    assert list(TO.OPERATOR_REGISTRY) == list(RO.OPERATOR_REGISTRY)
    assert list(TO.APPLY_OPS) == list(RO.APPLY_OPS)
    assert len(TO.OPERATOR_REGISTRY) >= 25


def test_vertex_and_edge_accessors(graphs):
    rg, tg, *_ = graphs
    rng = np.random.default_rng(0)
    vs = rng.integers(0, V, 17).astype(np.int32)
    es = rng.integers(0, E, 17).astype(np.int32)
    tv, te = torch.as_tensor(vs), torch.as_tensor(es)
    _exact(TO.get_vertex(tg, tv), RO.get_vertex(rg, vs))
    for a, b in zip(TO.get_edge_offset(tg, tv), RO.get_edge_offset(rg, vs)):
        _exact(a, b)
    _exact(TO.get_out_degree(tg, tv), RO.get_out_degree(rg, vs))
    _exact(TO.get_edge_src_id(tg, te), RO.get_edge_src_id(rg, es))
    _exact(TO.get_edge_dst_id(tg, te), RO.get_edge_dst_id(rg, es))
    _exact(TO.get_edge_weight(tg, te), RO.get_edge_weight(rg, es))


@pytest.mark.parametrize("max_degree", [1, 8, 40])
def test_neighbor_lists_pad_like_jax(graphs, max_degree):
    rg, tg, *_ = graphs
    rrev, trev = RG.reverse(rg), G.reverse(tg)
    for v in (0, 1, 7, V - 1):
        for a, b in zip(TO.get_out_edges_list(tg, v, max_degree),
                        RO.get_out_edges_list(rg, v, max_degree)):
            _exact(a, b)
        for a, b in zip(TO.get_in_edges_list(trev, v, max_degree),
                        RO.get_in_edges_list(rrev, v, max_degree)):
            _exact(a, b)
        _exact(TO.get_dest_v_list(tg, v, max_degree),
               RO.get_dest_v_list(rg, v, max_degree))
        _exact(TO.get_src_v_list(trev, v, max_degree),
               RO.get_src_v_list(rrev, v, max_degree))


def test_graph_mutators_are_functional(graphs):
    rg, tg, *_ = graphs
    rng = np.random.default_rng(1)
    vs = rng.choice(V, 9, replace=False).astype(np.int32)
    es = rng.choice(E, 9, replace=False).astype(np.int32)
    new = rng.uniform(-1, 1, 9).astype(np.float32)
    mask = rng.random(V) < 0.5
    full = rng.uniform(-1, 1, V).astype(np.float32)
    cases = [
        (TO.set_vertex_value(tg, torch.as_tensor(vs), torch.as_tensor(new)),
         RO.set_vertex_value(rg, vs, new)),
        (TO.update_vertex(tg, torch.as_tensor(full)),
         RO.update_vertex(rg, jnp.asarray(full))),
        (TO.update_vertex(tg, torch.as_tensor(full), torch.as_tensor(mask)),
         RO.update_vertex(rg, jnp.asarray(full), jnp.asarray(mask))),
        (TO.set_edge_weight(tg, torch.as_tensor(es), torch.as_tensor(new)),
         RO.set_edge_weight(rg, es, new)),
    ]
    for t, r in cases:
        for a, b in zip(_graph_fields(t), _graph_fields(r)):
            _exact(a, b)
    # the input graph is unchanged
    for a, b in zip(_graph_fields(tg), _graph_fields(graphs[0])):
        _exact(a, b)


def test_receive_masks_pad(graphs):
    _, tg, *_ = graphs
    rng = np.random.default_rng(2)
    vals = rng.uniform(-3, 3, V).astype(np.float32)
    ids = rng.integers(0, V, (40, 8)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.3] = PAD
    for pad_value in (0, -1.5):
        _exact(TO.receive(torch.as_tensor(vals), torch.as_tensor(ids),
                          pad_value),
               RO.receive(jnp.asarray(vals), jnp.asarray(ids), pad_value))


@pytest.mark.parametrize("op", ["add", "min", "max", "or"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_reduce_messages(op, dtype):
    rng = np.random.default_rng(3)
    msgs = (rng.uniform(-5, 5, (33, 9)) if dtype == np.float32
            else rng.integers(-50, 50, (33, 9))).astype(dtype)
    if op == "or":
        msgs = msgs > 0
    for axis in (-1, 0):
        t = TO.reduce_messages(torch.as_tensor(msgs), op, axis)
        r = RO.reduce_messages(jnp.asarray(msgs), op, axis)
        if op == "add" and dtype == np.float32:
            np.testing.assert_allclose(_np(t), _np(r), rtol=1e-5, atol=1e-6)
            assert _np(t).dtype == _np(r).dtype
        else:
            _exact(t, r)


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_reduce_by_segment_and_send(graphs, op, dtype):
    """Over the R-MAT graph's edges: messages by destination (PAD slots
    dropped by Reduce_segment as ids past the segments, and masked by
    Send), empty segments the identity."""
    _, _, src, dst, _ = graphs
    rng = np.random.default_rng(4)
    msgs = (rng.uniform(-5, 5, E) if dtype == np.float32
            else rng.integers(-50, 50, E)).astype(dtype)
    ids = dst.astype(np.int32).copy()
    ids[rng.random(E) < 0.2] = PAD
    t = TO.reduce_by_segment(torch.as_tensor(msgs), torch.as_tensor(ids),
                             V, op)
    r = RO.reduce_by_segment(jnp.asarray(msgs), jnp.asarray(ids), V, op)
    exact = not (op == "add" and dtype == np.float32)
    if exact:
        _exact(t, r)
    else:
        np.testing.assert_allclose(_np(t), _np(r), rtol=1e-5, atol=1e-5)
    if op != "add" and dtype == np.int32:
        return     # the JAX Send masks with a float identity: ill-typed
    base = (rng.uniform(-5, 5, V) if dtype == np.float32
            else rng.integers(-50, 50, V)).astype(dtype)
    t = TO.send(torch.as_tensor(base), torch.as_tensor(ids),
                torch.as_tensor(msgs), op)
    r = RO.send(jnp.asarray(base), jnp.asarray(ids), jnp.asarray(msgs), op)
    if exact:
        _exact(t, r)
    else:
        np.testing.assert_allclose(_np(t), _np(r), rtol=1e-5, atol=1e-5)


def test_frontier_operators():
    roots = np.asarray([0, 5, 17, 299])
    t = TO.make_frontier(V, roots)
    r = RO.make_frontier(V, roots)
    _exact(t, r)
    _exact(TO.get_active_vertex(t), RO.get_active_vertex(r))
    _exact(TO.frontier_size(t), RO.frontier_size(r))
    empty = TO.make_frontier(V, np.asarray([], np.int64))
    assert not bool(TO.get_active_vertex(empty))
    upd = np.random.default_rng(6).random(V) < 0.1
    _exact(TO.advance_frontier(t, torch.as_tensor(upd)),
           RO.advance_frontier(r, jnp.asarray(upd)))


@pytest.mark.parametrize("name", list(RO.APPLY_OPS))
def test_apply_ops(name):
    rng = np.random.default_rng(7)
    x = rng.uniform(0.5, 8, 64).astype(np.float32)
    y = rng.uniform(0.5, 8, 64).astype(np.float32)
    xi = rng.integers(1, 40, 64).astype(np.int32)
    yi = rng.integers(1, 9, 64).astype(np.int32)
    for a, b in ((x, y), (xi, yi)):
        t = TO.apply_op(name, torch.as_tensor(a), torch.as_tensor(b))
        r = RO.apply_op(name, jnp.asarray(a), jnp.asarray(b))
        if name == "damped_sum":           # (s, d): a second argument is d
            t = TO.apply_op(name, torch.as_tensor(a))
            r = RO.apply_op(name, jnp.asarray(a))
        _exact(t, r)
        assert TO.OPERATOR_REGISTRY[f"Apply_{name}"] is TO.APPLY_OPS[name]


# ---------------------------------------------------------------------------
# preprocessing helpers (numpy on the host)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["block", "dst_hash", "hybrid",
                                      "community"])
@pytest.mark.parametrize("parts", [1, 3, 4])
def test_partition_edges_equal_jax(graphs, strategy, parts):
    _, _, src, dst, _ = graphs
    kw = {"device": "cpu"} if strategy == "community" else {}
    t = TP.partition_edges(src, dst, parts, strategy, **kw)
    r = RP.partition_edges(src, dst, parts, strategy)
    assert len(t) == len(r) == parts
    for a, b in zip(t, r):
        _exact(a, b)
    assert sorted(np.concatenate(t).tolist()) == list(range(len(src)))


def test_partition_edges_hybrid_stripes_hubs():
    """A hub past the cut has its edges striped across parts, as the JAX
    function stripes them."""
    rng = np.random.default_rng(8)
    src = rng.integers(0, 400, 3000).astype(np.int32)
    dst = np.concatenate([np.zeros(600, np.int32),
                          rng.integers(1, 400, 2400).astype(np.int32)])
    t = TP.partition_edges(src, dst, 4, "hybrid")
    r = RP.partition_edges(src, dst, 4, "hybrid")
    for a, b in zip(t, r):
        _exact(a, b)
    assert all((dst[p] == 0).sum() == 150 for p in t)


def test_partition_edges_rejects_unknown_strategy(graphs):
    _, _, src, dst, _ = graphs
    with pytest.raises(ValueError):
        TP.partition_edges(src, dst, 2, "random")


@pytest.mark.parametrize("strategy", ["degree", "bfs", "identity"])
def test_reorder_equal_jax(graphs, strategy):
    _, _, src, dst, _ = graphs
    t = TP.reorder(src, dst, V, strategy)
    r = RP.reorder(src, dst, V, strategy)
    for a, b in zip(t, r):
        _exact(a, b)
    perm = t[2]
    assert sorted(perm.tolist()) == list(range(V))


@pytest.mark.parametrize("to", ["csr", "csc", "ell"])
def test_layout_equal_jax(graphs, to):
    _, _, src, dst, w = graphs
    t = TP.layout(src, dst, to, num_vertices=V, weights=w)
    r = RP.layout(src, dst, to, num_vertices=V, weights=w)
    if to == "ell":
        assert t.num_buckets == r.num_buckets
        for name in ("src_ids", "dst", "weights"):
            for a, b in zip(getattr(t, name), getattr(r, name)):
                _exact(a, b)
    else:
        for a, b in zip(_graph_fields(t), _graph_fields(r)):
            _exact(a, b)
    assert (t.num_vertices, t.num_edges) == (r.num_vertices, r.num_edges)
    with pytest.raises(ValueError):
        TP.layout(src, dst, "coo")


def test_write_values_byte_equal(tmp_path):
    vals = np.random.default_rng(9).uniform(-1, 1, 77).astype(np.float32)
    TP.write_values(str(tmp_path / "t.npy"), torch.as_tensor(vals))
    RP.write_values(str(tmp_path / "r.npy"), jnp.asarray(vals))
    assert (tmp_path / "t.npy").read_bytes() == \
        (tmp_path / "r.npy").read_bytes()
    ints = np.arange(10, dtype=np.int32)
    TP.write_values(str(tmp_path / "ti.npy"), ints)
    RP.write_values(str(tmp_path / "ri.npy"), ints)
    assert (tmp_path / "ti.npy").read_bytes() == \
        (tmp_path / "ri.npy").read_bytes()
