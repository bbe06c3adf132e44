"""The port's spans and counters (``repro_torch.core.tracing``, the run
loop, the lane loop and the graph server) and the benchmark's readers of
them, on the CPU.

Outside a profiler a span keeps nothing.  Under ``torch.profiler`` a
BFS records one ``run.read`` a superstep plus the last and one
``run.pull`` or ``run.push`` a superstep, in turn; the ranges reach the
profiler's events.  A span's self time leaves out its children.  Tracing
changes no answer.  The server's counters (queries admitted, their wait for a
lane, lanes a batched superstep stepped) agree with what its queries
record, on the dense and the streamed engine.
"""
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import profile

from repro_torch.core import dsl, tracing
from repro_torch.core import graph as G
from repro_torch.core.scheduler import (AdmissionPolicy, DirectionPolicy,
                                        ScheduleConfig)
from repro_torch.core.translator import translate
from repro_torch.serve.graph_serve import GraphServer
from torch_threads import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.harness import cell, spans as bench_spans  # noqa: E402
from bench.harness import trace as bench_trace  # noqa: E402
from bench.harness.spec import Spec  # noqa: E402

CPU = "cpu"
RUN_SPANS = ("run.read", "run.pull", "run.push")


@pytest.fixture(scope="module")
def g():
    rng = np.random.default_rng(3)
    src, dst = G.rmat_edges(400, 4000, seed=11)
    w = rng.uniform(0.5, 2.0, size=src.shape[0]).astype(np.float32)
    return G.from_edge_list(src, dst, weights=w, num_vertices=400)


def traced():
    """A CPU profiler session: the program's spans record inside it."""
    return profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _cfg(mode="auto", **kw):
    # alpha 4: the small graph's BFS pushes and pulls both
    return ScheduleConfig(direction=DirectionPolicy(mode=mode, alpha=4.0),
                          **kw)


def _root(g):
    return int(np.argmax(g.out_degrees.cpu().numpy()))


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------


def test_off_by_default_keeps_nothing(g):
    off = tracing.span("run.read")
    assert off is tracing.span("serve.harvest")  # one shared no-op
    with off as inside:
        assert inside is None
    cp = translate(dsl.bfs_program(), g, _cfg(), device=CPU)
    lo = time.perf_counter()
    cp.run(roots=_root(g))
    assert tracing.records(lo, time.perf_counter()) == []


def test_a_traced_bfs_records_its_supersteps(g):
    cp = translate(dsl.bfs_program(), g, _cfg(), device=CPU)
    lo = time.perf_counter()
    with traced() as prof:
        cp.run(roots=_root(g))
    hi = time.perf_counter()
    st = cp.last_run_stats
    steps = st["pull_supersteps"] + st["push_supersteps"]
    assert st["pull_supersteps"] > 0 and st["push_supersteps"] > 0
    got = sorted(tracing.records(lo, hi), key=lambda s: s.t0)
    assert tracing.count("run.read", lo, hi) == steps + 1
    assert tracing.count(("run.pull", "run.push"), lo, hi) == steps
    assert tracing.count("run.pull", lo, hi) == st["pull_supersteps"]
    assert {s.name for s in got} == set(RUN_SPANS)
    # a read, then a superstep's enqueue, in turn, none inside another
    assert [s.name == "run.read" for s in got] == [
        i % 2 == 0 for i in range(len(got))]
    assert all(s.parent is None for s in got)
    assert all(a.t1 <= b.t0 for a, b in zip(got, got[1:]))
    for n in RUN_SPANS:     # no children: self time is the duration
        assert tracing.self_seconds(n, lo, hi) == pytest.approx(
            sum(s.t1 - s.t0 for s in got if s.name == n), rel=1e-12)
    names = {e.name for e in prof.events()}
    assert {tracing.PREFIX + n for n in RUN_SPANS} <= names


@pytest.mark.parametrize("checkpointed", [False, True])
def test_tracing_changes_no_answer(g, tmp_path, checkpointed):
    cp = translate(dsl.sssp_program(), g, _cfg(), device=CPU)
    kw = {"checkpoint_dir": str(tmp_path / "a")} if checkpointed else {}
    want, it = cp.run(roots=_root(g), **kw)
    want_stats = dict(cp.last_run_stats)
    lo = time.perf_counter()
    kw = {"checkpoint_dir": str(tmp_path / "b")} if checkpointed else {}
    with traced():
        got, it2 = cp.run(roots=_root(g), **kw)
    hi = time.perf_counter()
    assert it2 == it
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    stats = dict(cp.last_run_stats)
    for d in (stats, want_stats):
        d.pop("checkpoint_write_s", None)       # a measured time
    assert stats == want_stats
    # a checkpointed run steps its one lane through the lane loop
    inner = "lane.read" if checkpointed else "run.read"
    assert tracing.count(inner, lo, hi) > 0


def test_spans_nest_and_self_time_excludes_children():
    lo = time.perf_counter()
    with traced():
        with tracing.span("outer") as outer:
            with tracing.span("inner") as inner:
                pass
    hi = time.perf_counter()
    assert inner.parent is outer and outer.parent is None
    assert tracing.span("outer") is tracing.span("inner")   # off again
    assert [s.name for s in tracing.records(lo, hi)] == ["inner", "outer"]
    assert tracing.self_seconds("outer", lo, hi) == pytest.approx(
        (outer.t1 - outer.t0) - (inner.t1 - inner.t0), abs=1e-12)
    assert tracing.self_seconds(("outer", "inner"), lo, hi) == \
        pytest.approx(outer.t1 - outer.t0, abs=1e-12)
    assert tracing.count(("outer", "inner"), lo, hi) == 2
    assert tracing.records(hi, hi + 1.0) == []


# ---------------------------------------------------------------------------
# the server's counters and spans
# ---------------------------------------------------------------------------

STREAM = [("bfs", 0), ("sssp", 5), ("bfs", 17), ("sssp", 5), ("bfs", 0),
          ("sssp", 250), ("bfs", 299), ("bfs", 42), ("sssp", 9),
          ("bfs", 3), ("bfs", 77), ("sssp", 123)]


@pytest.mark.parametrize("schedule", [
    _cfg(), _cfg("pull", partitions=2)], ids=["dense", "streamed"])
def test_server_counts_admissions_waits_and_lanes(g, schedule):
    slots = 3
    srv = GraphServer(g, schedule=schedule, device=CPU,
                      admission=AdmissionPolicy(slots=slots,
                                                slice_supersteps=2))
    lo = time.perf_counter()
    with traced():
        handles = [srv.submit(k, r) for k, r in STREAM]
        srv.run()
    hi = time.perf_counter()
    c = srv.counters()
    assert "slices" not in c
    assert all(q.done and q.answer_quality == "exact" for q in handles)
    laned = [q for q in handles if q.served_by == "batch"]
    assert len(laned) < len(handles)            # some were coalesced
    assert c["admitted"] == len(laned)
    assert all(q.submitted_s <= q.admitted_s <= q.finished_s for q in laned)
    assert all(q.admitted_s is None for q in handles
               if q.served_by == "coalesced")
    assert c["queue_wait_s"] == pytest.approx(
        sum(q.admitted_s - q.submitted_s for q in laned))
    assert 0 <= c["queue_wait_s"] <= sum(q.finished_s - q.submitted_s
                                         for q in handles)
    assert c["batched_supersteps"] > 0
    assert 1 <= c["lane_steps"] / c["batched_supersteps"] <= slots
    # the spans: a group's admit and harvest a step, the lane loop's
    # between them
    got = tracing.records(lo, hi)
    assert {s.name for s in got} == {"serve.admit", "serve.harvest",
                                     "lane.step", "lane.read"}
    assert all(s.parent is None for s in got)
    assert tracing.count("lane.read", lo, hi) == c["batched_supersteps"]
    assert tracing.count("lane.step", lo, hi) == c["batched_supersteps"]
    assert tracing.count("serve.harvest", lo, hi) >= c["harvests"]
    assert tracing.count("serve.admit", lo, hi) == tracing.count(
        "serve.harvest", lo, hi)


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------


def _spans(names_and_children):
    """Record ``[(name, [child names])]`` as spans; returns the stretch
    ``(lo, hi)`` and the spans recorded in it."""
    lo = time.perf_counter()
    with traced():
        for name, children in names_and_children:
            with tracing.span(name):
                for child in children:
                    with tracing.span(child):
                        pass
    hi = time.perf_counter()
    return lo, hi, tracing.records(lo, hi)


def _record(lo=0.0, hi=0.0, **kw):
    rec = cell.Record(num_vertices=16, spans=bench_spans.Spans(), **kw)
    rec.trace = bench_trace.TraceSummary(
        window_s=hi - lo, busy_s=0.0, start=lo, end=hi, device_ops=[],
        idle_gaps=[])
    return rec


def _ms(spans, names):
    """Self milliseconds of the spans named ``names``."""
    return 1e3 * sum((s.t1 - s.t0) * (s.name in names)
                     - (s.t1 - s.t0) * (s.parent is not None
                                        and s.parent.name in names)
                     for s in spans)


def _searches():
    # two searches of two supersteps; a stray child span inside a read
    # is not the read's self time
    lo, hi, got = _spans([("run.read", ["other"]), ("run.pull", []),
                          ("run.read", []), ("run.push", []),
                          ("run.read", [])] * 2)
    return lo, hi, got


def _superstep_read():
    lo, hi, got = _searches()
    return _record(lo, hi), _ms(got, {"run.read"}) / 4


def _superstep_enqueue():
    lo, hi, got = _searches()
    return _record(lo, hi), _ms(got, {"run.pull", "run.push"}) / 4


def _queue_wait():
    rec = _record(counters={"queue_wait_s": 1.5, "admitted": 10})
    return rec, 150.0


def _lanes():
    rec = _record(counters={"lane_steps": 30, "batched_supersteps": 12})
    return rec, 2.5


def _per_query(name):
    def make():
        lo, hi, got = _spans([(name, []), ("lane.step", []), (name, [])])
        mid = 0.5 * (lo + hi)
        queries = [{"served_by": "batch", "at": mid},
                   {"served_by": "exact", "at": mid},
                   {"served_by": "landmark", "at": mid},
                   {"served_by": "batch", "at": hi + 1.0}]
        return _record(lo, hi, queries=queries), _ms(got, {name}) / 2
    return make


def _each(name):
    def make():
        lo, hi, got = _spans([("lane.step", []), ("lane.read", []),
                              ("serve.harvest", []), ("lane.step", []),
                              ("lane.read", [])])
        return _record(lo, hi), _ms(got, {name}) / 2
    return make


READERS = {
    "superstep_read_ms": ("program_span", "graph500-s21.bfs",
                          _superstep_read),
    "superstep_enqueue_ms": ("program_span", "graph500-s21.bfs",
                             _superstep_enqueue),
    "queue_wait_ms_per_query": ("program_counter",
                                "graph500-s21-serve.mixed-c32", _queue_wait),
    "lanes_per_batched_superstep": ("program_counter",
                                    "graph500-s21-serve.mixed-c32", _lanes),
    "harvest_ms_per_query": ("program_span", "graph500-s21-serve.mixed-c32",
                             _per_query("serve.harvest")),
    "admit_ms_per_query": ("program_span", "graph500-s21-serve.mixed-c32",
                           _per_query("serve.admit")),
    "lane_read_ms": ("program_span", "graph500-s21-serve.mixed-c32",
                     _each("lane.read")),
    "lane_step_ms": ("program_span", "graph500-s21-serve.mixed-c32",
                     _each("lane.step")),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_reads_its_value_and_nothing_from_an_empty_record(metric):
    source, workload, make = READERS[metric]
    spec = Spec(ROOT)
    entry = next(m for m in spec.bench["per_layer"] if m["name"] == metric)
    assert entry["source"] == source and entry["workloads"] == [workload]
    read = spec.reader(metric)
    rec, want = make()
    assert read(rec) == pytest.approx(want, rel=1e-9)
    empty = cell.Record(num_vertices=16, spans=bench_spans.Spans())
    assert read(empty) is None
    # a traced stretch with nothing of the program's in it
    assert read(_record(-2.0, -1.0)) is None
