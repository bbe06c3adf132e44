"""Port parity: the graph-query server (``repro_torch.serve.graph_serve``)
on the CPU, case for case with ``tests/test_graph_serve.py`` (its
multi-PE case waits for the multi-PE port).

Every served answer is bit-exact against the port's sequential
``run(roots=root)`` oracle, across templates × directions × arrival
orders, and the served answers, ``served_by`` and per-lane stats equal
the JAX package's server on the same stream; the lane semantics the
plane relies on (duplicate roots, isolated roots, k = 1 / k > slots,
per-lane stats under freeze), the continuation API (sliced resume,
mid-flight admits), landmark bounds on email-Eu-core (equal to the JAX
package's table), and a hypothesis sweep over random query streams and
admission timings (behind importorskip).
"""
import numpy as np
import pytest

import repro.core  # noqa: F401  (import order: core before kernels)
from repro.core import graph as RG
from repro.core import preprocess as RP
from repro.core import scheduler as RS
from repro.serve import graph_serve as RGS

import torch
from repro_torch.core import dsl
from repro_torch.core import graph as G
from repro_torch.core.preprocess import load_paper_graph
from repro_torch.core.scheduler import (AdmissionPolicy, DirectionPolicy,
                                        ScheduleConfig)
from repro_torch.core.translator import translate
from repro_torch.errors import InvalidQuery, QueueFull
from repro_torch.serve.graph_serve import (GraphServer, build_landmark_table,
                                           choose_landmarks)
from torch_threads import one_thread  # noqa: F401

CPU = "cpu"


def _edges():
    rng = np.random.default_rng(3)
    src, dst = RG.rmat_edges(300, 3000, seed=7)
    w = rng.uniform(0.5, 2.0, size=src.shape[0]).astype(np.float32)
    return src, dst, w


@pytest.fixture(scope="module")
def g():
    src, dst, w = _edges()
    return G.from_edge_list(src, dst, weights=w, num_vertices=300)


@pytest.fixture(scope="module")
def rg():
    src, dst, w = _edges()
    return RG.from_edge_list(src, dst, weights=w, num_vertices=300)


@pytest.fixture(scope="module")
def euro():
    return load_paper_graph("email-Eu-core")


def _cfg(mode="auto"):
    return ScheduleConfig(direction=DirectionPolicy(mode=mode))


def _server(g, cfg=None, **kw):
    return GraphServer(g, schedule=cfg or _cfg(), device=CPU, **kw)


_ORACLES: dict = {}


def _oracle(program, graph, cfg, root):
    """Sequential run(roots=root), memoized."""
    key = (program, id(graph), cfg, root)
    if key not in _ORACLES:
        prog = translate(program, graph, cfg, device=CPU)
        vals, it = prog.run(roots=root)
        _ORACLES[key] = (vals.numpy(), int(it), dict(prog.last_run_stats))
    return _ORACLES[key]


def _check(q, graph, cfg):
    __tracebackhide__ = True
    assert q.done, q.status
    ref, it, stats = _oracle(q.program, graph, cfg, q.root)
    if q.kind == "dist":
        assert q.result == float(ref[q.target]), \
            (q.root, q.target, q.served_by)
    else:
        assert isinstance(q.result, np.ndarray)
        np.testing.assert_array_equal(q.result, ref,
                                      err_msg=f"{q.kind} root={q.root}")
        assert q.iters == it, (q.kind, q.root, q.iters, it)
        for k in ("push_supersteps", "pull_supersteps", "direction_switches",
                  "edges_traversed", "terminated"):
            assert q.stats[k] == stats[k], (k, q.kind, q.root)


# ---------------------------------------------------------------------------
# 1. differential harness: templates × directions × arrival orders
# ---------------------------------------------------------------------------


STREAM = [("bfs", 0), ("sssp", 5), ("ppr", 7), ("bfs", 17), ("sssp", 5),
          ("bfs", 0), ("sssp", 250), ("bfs", 299), ("ppr", 7), ("bfs", 42)]


@pytest.mark.parametrize("mode", ["pull", "push", "auto"])
def test_served_answers_bit_exact(g, rg, mode):
    """Bit-exact against the sequential oracle, and the same answers,
    iters, ``served_by`` and stats as the JAX package's server (ppr within
    rtol 1e-5 of it)."""
    cfg = _cfg(mode)
    srv = _server(g, cfg, admission=AdmissionPolicy(slots=3,
                                                    slice_supersteps=2))
    handles = [srv.submit(k, r) for k, r in STREAM]
    srv.run()
    for q in handles:
        _check(q, g, cfg)
    assert sum(q.served_by == "coalesced" for q in handles) >= 1
    ref = RGS.GraphServer(
        rg, schedule=RS.ScheduleConfig(direction=RS.DirectionPolicy(
            mode=mode)),
        admission=RS.AdmissionPolicy(slots=3, slice_supersteps=2))
    ref_handles = [ref.submit(k, r) for k, r in STREAM]
    ref.run()
    for a, b in zip(ref_handles, handles):
        assert (a.served_by, a.iters, a.qid) == (b.served_by, b.iters, b.qid)
        if a.kind == "ppr":
            np.testing.assert_allclose(b.result, np.asarray(a.result),
                                       rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_array_equal(b.result, np.asarray(a.result))
        assert a.stats == b.stats, a.kind


def test_arrival_order_invariance(g):
    """Any permutation of the same stream serves identical answers."""
    cfg = _cfg("auto")
    baseline: dict[int, np.ndarray] = {}
    for seed in (0, 1, 2):
        order = np.random.default_rng(seed).permutation(len(STREAM))
        srv = _server(g, cfg, admission=AdmissionPolicy(slots=2,
                                                        slice_supersteps=1))
        handles = {int(i): srv.submit(*STREAM[int(i)]) for i in order}
        srv.run()
        for i, q in handles.items():
            _check(q, g, cfg)
            if seed == 0:
                baseline[i] = q.result
            else:
                np.testing.assert_array_equal(q.result, baseline[i])


def test_submit_validation(g):
    srv = _server(g)
    with pytest.raises(ValueError, match="unsupported query kind"):
        srv.submit("pagerank", 0)
    with pytest.raises(ValueError, match="out of range"):
        srv.submit("bfs", g.num_vertices)
    with pytest.raises(ValueError, match="need target"):
        srv.submit("dist", 0)
    with pytest.raises(InvalidQuery, match="only for dist"):
        srv.submit("bfs", 0, target=3)


def test_admission_policy_validation():
    with pytest.raises(ValueError):
        AdmissionPolicy(slots=0)
    with pytest.raises(ValueError):
        AdmissionPolicy(slice_supersteps=0)
    with pytest.raises(ValueError):
        AdmissionPolicy(max_queue=-1)
    assert AdmissionPolicy().describe() == RS.AdmissionPolicy().describe()
    assert "slots=8" in AdmissionPolicy().describe()


def test_queue_backpressure(g):
    srv = _server(g, admission=AdmissionPolicy(max_queue=2))
    srv.submit("bfs", 1)
    srv.submit("bfs", 2)
    with pytest.raises(RuntimeError, match="queue full") as ei:
        srv.submit("bfs", 3)
    assert isinstance(ei.value, QueueFull) and ei.value.max_queue == 2
    srv.run()
    srv.submit("bfs", 3)            # drained queue admits again


def test_default_device_is_cuda(g, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GraphServer(g)


# ---------------------------------------------------------------------------
# 2. run_batch lane semantics the serving plane relies on
# ---------------------------------------------------------------------------


def test_run_batch_duplicate_roots(g):
    cp = translate(dsl.bfs_program(), g, _cfg("auto"), device=CPU)
    vals, iters = cp.run_batch(np.asarray([5, 5, 9, 5]))
    ref, it = cp.run(roots=5)
    for lane in (0, 1, 3):
        assert torch.equal(vals[lane], ref)
        assert int(iters[lane]) == int(it)


def test_run_batch_isolated_root():
    """A 0-degree root lane converges immediately and stays frozen while
    the other lanes run to their full depth."""
    src = np.asarray([0, 1, 2, 3], np.int32)
    dst = np.asarray([1, 2, 3, 4], np.int32)
    gi = G.from_edge_list(src, dst, num_vertices=8)   # 5..7 isolated
    cp = translate(dsl.bfs_program(), gi, _cfg("auto"), device=CPU)
    vals, iters = cp.run_batch(np.asarray([6, 0]))
    for lane, root in enumerate((6, 0)):
        ref, it = cp.run(roots=root)
        assert torch.equal(vals[lane], ref)
        assert int(iters[lane]) == int(it)
    assert int(iters[0]) < int(iters[1])      # isolated lane froze early


def test_run_batch_k1_matches_sequential(g):
    cp = translate(dsl.sssp_program(), g, _cfg("auto"), device=CPU)
    vals, iters = cp.run_batch(np.asarray([17]))
    assert cp.last_run_stats["batch_size"] == 1
    ref, it = cp.run(roots=17)
    assert torch.equal(vals[0], ref)
    assert int(iters[0]) == int(it)


def test_more_queries_than_slots(g):
    """k > slots drains through continuation, every answer exact."""
    cfg = _cfg("auto")
    srv = _server(g, cfg, admission=AdmissionPolicy(slots=2,
                                                    slice_supersteps=1))
    handles = [srv.submit("bfs", r) for r in range(11)]
    srv.run()
    for q in handles:
        _check(q, g, cfg)


def test_per_lane_stats_under_freeze(g):
    """Sliced-batch per-lane counters equal each lane's sequential run:
    a converged (frozen) lane must stop counting while others continue."""
    cfg = _cfg("auto")
    cp = translate(dsl.bfs_program(), g, cfg, device=CPU)
    roots = [0, 7, 250]
    st = cp.batch_init(np.asarray(roots))
    while not cp.lane_done(st).all():
        st = cp.run_batch_slice(st, 1)            # superstep at a time
    stats = cp.lane_stats(st)
    for lane, root in enumerate(roots):
        cp.run(roots=root)
        seq = cp.last_run_stats
        for key in ("push_supersteps", "push_compacted_supersteps",
                    "pull_supersteps", "direction_switches",
                    "edges_traversed", "pull_blocks_swept",
                    "pull_blocks_skipped"):
            assert stats[key][lane] == seq[key], (key, root)


# ---------------------------------------------------------------------------
# 3. continuation API: sliced resume ≡ one-shot, admits don't perturb
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["pull", "push", "auto"])
def test_sliced_resume_bit_exact(g, mode):
    cp = translate(dsl.sssp_program(), g, _cfg(mode), device=CPU)
    roots = np.asarray([0, 5, 5, 17])
    ref_vals, ref_iters = cp.run_batch(roots)
    st = cp.batch_init(roots)
    for budget in (1, 2, 3, 1, 50):               # uneven slice boundaries
        st = cp.run_batch_slice(st, budget)
        if cp.lane_done(st).all():
            break
    assert cp.lane_done(st).all()
    assert torch.equal(st.values, ref_vals)
    np.testing.assert_array_equal(st.iters, ref_iters.numpy())


def test_lane_admit_leaves_other_lanes_frozen(g):
    cp = translate(dsl.bfs_program(), g, _cfg("auto"), device=CPU)
    roots = np.asarray([0, 5, 17])
    st = cp.run_batch_slice(cp.batch_init(roots), 100)
    assert cp.lane_done(st).all()
    before = st.values.clone()
    admitted = cp.lane_admit(st, 1, 42)
    assert torch.equal(st.values, before)      # the old state is untouched
    st = cp.run_batch_slice(admitted, 100)
    ref, it = cp.run(roots=42)
    assert torch.equal(st.values[1], ref)
    assert int(st.iters[1]) == int(it)
    assert torch.equal(st.values[0], before[0])
    assert torch.equal(st.values[2], before[2])


def test_batch_idle_lanes_do_not_step(g):
    cp = translate(dsl.bfs_program(), g, _cfg("auto"), device=CPU)
    idle = cp.batch_idle(4)
    assert cp.lane_done(idle).all()
    stepped = cp.run_batch_slice(idle, 10)
    np.testing.assert_array_equal(stepped.iters, np.zeros(4, np.int32))
    assert stepped.values is idle.values       # nothing launched


def test_server_counts_one_read_per_batched_superstep(g):
    """The serving plane's device→host reads: one a batched superstep and
    one a harvest that finished a query (only its lanes copied)."""
    srv = _server(g, admission=AdmissionPolicy(slots=3, slice_supersteps=2))
    for k, r in STREAM:
        srv.submit(k, r)
    srv.run()
    c = srv.counters()
    assert c["batched_supersteps"] > 0 and c["harvests"] > 0
    assert c["host_reads"] == c["batched_supersteps"] + c["harvests"]
    assert 0 < c["masked_sweeps"] <= c["batched_supersteps"]


# ---------------------------------------------------------------------------
# 4. landmark table (email-Eu-core)
# ---------------------------------------------------------------------------


def test_landmark_bounds_sane(euro):
    """lower ≤ exact ≤ upper on every sampled (s, t) pair."""
    tab = build_landmark_table(euro, 8, device=CPU)
    cp = translate(dsl.sssp_program(), euro, ScheduleConfig(), device=CPU)
    rng = np.random.default_rng(0)
    for s in rng.integers(0, euro.num_vertices, 4):
        ref = cp.run(roots=int(s))[0].numpy()
        for t in rng.integers(0, euro.num_vertices, 25):
            lo, up = tab.bounds(int(s), int(t))
            d = float(ref[int(t)])
            assert lo <= d + 1e-4, (int(s), int(t), lo, d)
            assert d <= up + 1e-4, (int(s), int(t), d, up)


def test_landmark_rebuild_deterministic(euro):
    a = build_landmark_table(euro, 4, device=CPU)
    b = build_landmark_table(euro, 4, device=CPU)
    np.testing.assert_array_equal(a.landmarks, b.landmarks)
    np.testing.assert_array_equal(a.d_out, b.d_out)
    np.testing.assert_array_equal(a.d_in, b.d_in)
    # degree-ranked and within range
    assert len(set(a.landmarks.tolist())) == 4
    assert choose_landmarks(euro, 4).tolist() == a.landmarks.tolist()
    # the JAX package's table for the same graph
    ref = RGS.build_landmark_table(RP.load_paper_graph("email-Eu-core"), 4)
    np.testing.assert_array_equal(a.landmarks, ref.landmarks)
    np.testing.assert_array_equal(a.d_out, ref.d_out)
    np.testing.assert_array_equal(a.d_in, ref.d_in)


def test_dist_exact_fallback_triggers(g):
    """With one weak landmark, some pair's bounds don't pin — that query
    must fall back to an exact SSSP and still answer exactly."""
    cfg = _cfg("auto")
    srv = _server(g, cfg, landmarks=1)
    pair = None
    rng = np.random.default_rng(1)
    for _ in range(500):
        s, t = (int(x) for x in rng.integers(0, g.num_vertices, 2))
        if s != t and not srv.table.pinned(s, t):
            pair = (s, t)
            break
    assert pair is not None, "1-landmark table pinned every sampled pair"
    q = srv.submit("dist", pair[0], target=pair[1])
    srv.run()
    assert q.served_by == "exact"
    _check(q, g, cfg)


def test_dist_landmark_pinned_paths(g):
    srv = _server(g, _cfg("auto"), landmarks=4)
    same = srv.submit("dist", 3, target=3)       # s == t pins to 0
    assert same.done and same.served_by == "landmark"
    assert same.result == 0.0
    # a landmark endpoint always pins: d(L, t) is a table row
    L = int(srv.table.landmarks[0])
    cp = translate(dsl.sssp_program(), g, _cfg("auto"), device=CPU)
    ref = cp.run(roots=L)[0].numpy()
    q = srv.submit("dist", L, target=77)
    if q.served_by == "landmark":                # pinned without engine
        assert q.done
    else:
        srv.run()
    assert q.result == float(ref[77])


def test_dist_without_table_is_exact(g):
    cfg = _cfg("auto")
    srv = _server(g, cfg)                        # landmarks=0 → no table
    q = srv.submit("dist", 3, target=250)
    s = srv.submit("sssp", 3)                    # coalesces with the inner
    srv.run()
    assert q.served_by == "exact"
    _check(q, g, cfg)
    assert s.served_by == "coalesced"
    _check(s, g, cfg)


# ---------------------------------------------------------------------------
# 5. hypothesis sweep: random streams, random admission timing
# ---------------------------------------------------------------------------


def test_property_random_streams_and_timing(g):
    pytest.importorskip("hypothesis",
                        reason="hypothesis not installed (tier-2 dep)")
    from hypothesis import given, settings, strategies as st

    cfg = _cfg("auto")

    @settings(max_examples=10, deadline=None)
    @given(st.data())
    def sweep(data):
        slots = data.draw(st.integers(1, 4), label="slots")
        budget = data.draw(st.integers(1, 5), label="slice_supersteps")
        coalesce = data.draw(st.booleans(), label="coalesce")
        n = data.draw(st.integers(1, 8), label="stream_len")
        stream = data.draw(st.lists(
            st.tuples(st.sampled_from(["bfs", "sssp"]),
                      st.integers(0, g.num_vertices - 1)),
            min_size=n, max_size=n), label="stream")
        srv = _server(g, cfg, admission=AdmissionPolicy(
            slots=slots, slice_supersteps=budget, coalesce=coalesce))
        handles = []
        for kind, root in stream:
            handles.append(srv.submit(kind, root))
            # random admission timing: maybe advance the plane mid-stream
            if data.draw(st.booleans(), label="step_now"):
                srv.step()
        srv.run()
        for q in handles:
            _check(q, g, cfg)

    sweep()
