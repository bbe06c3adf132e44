"""Port parity: durable snapshots, crash recovery and the fault registry,
on the CPU.

Case for case with ``tests/test_checkpoint.py`` (the format, the
fingerprints, the lane round trip, the mismatch surfaces),
``tests/test_crash_recovery.py`` (its resident and server cases; the
streamed ones wait for the streaming port) and ``tests/test_faults.py``
(the registry and the serving slice fault).  Snapshots cross packages: a
lane snapshot the JAX package writes restores in the port and finishes
equal to the JAX ``run_batch``, and one the port writes reads and
restores in the JAX package; ``fingerprint_graph`` and
``fingerprint_schedule`` give the JAX package's values.
"""
import dataclasses
import json
import os
import signal

import numpy as np
import pytest

import repro.core  # noqa: F401  (import order: core before kernels)
from repro.core import checkpoint as RC
from repro.core import dsl as RD
from repro.core import graph as RG
from repro.core import scheduler as RS
from repro.core import translator as RT

import torch
from repro_torch import errors
from repro_torch.core import checkpoint as ckpt
from repro_torch.core import dsl
from repro_torch.core import faults
from repro_torch.core import graph as G
from repro_torch.core.scheduler import (AdmissionPolicy, DirectionPolicy,
                                        ScheduleConfig)
from repro_torch.core.translator import CompiledGraphProgram, translate
from repro_torch.errors import (CheckpointCorruptError, CheckpointError,
                                CheckpointMismatchError, InjectedFault)
from repro_torch.serve.graph_serve import GraphServer
from torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.chaos

CPU = "cpu"
TIMEOUT_S = 300


@pytest.fixture(autouse=True)
def _no_hang_and_clean_registry():
    """SIGALRM watchdog (no test may hang) + pristine fault registry."""
    faults.reset()

    def _alarm(signum, frame):
        raise AssertionError(f"checkpoint test hung (> {TIMEOUT_S}s)")

    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        faults.reset()


def _edges(V, E, seed):
    return RG.rmat_edges(V, E, seed=seed)


@pytest.fixture(scope="module")
def g():
    src, dst = _edges(400, 3200, 11)
    return G.from_edge_list(src, dst, num_vertices=400)


@pytest.fixture(scope="module")
def g2():
    src, dst = _edges(400, 3200, 12)
    return G.from_edge_list(src, dst, num_vertices=400)


@pytest.fixture(scope="module")
def rg():
    src, dst = _edges(400, 3200, 11)
    return RG.from_edge_list(src, dst, num_vertices=400)


@pytest.fixture(scope="module")
def gc():
    """The crash-recovery graph (``tests/test_crash_recovery.py``'s)."""
    src, dst = _edges(500, 4000, 5)
    return G.from_edge_list(src, dst, num_vertices=500)


# ---------------------------------------------------------------------------
# snapshot format
# ---------------------------------------------------------------------------


def test_write_read_round_trip(tmp_path):
    arrays = {"a": np.arange(12, dtype=np.int64).reshape(3, 4),
              "b": np.linspace(0, 1, 5, dtype=np.float32),
              "t": torch.arange(6, dtype=torch.int32)}
    meta = {"root": 3, "note": "x", "n": np.int64(4)}
    fps = {"graph": "graph:x", "program": "program:y"}
    stem = ckpt.write_snapshot(str(tmp_path), "lane", 0, arrays, meta, fps)
    manifest, back = ckpt.read_snapshot(stem, kind="lane", expect=fps)
    assert manifest["meta"]["root"] == 3 and manifest["meta"]["n"] == 4
    assert manifest["seq"] == 0
    for k, v in arrays.items():
        v = v.numpy() if isinstance(v, torch.Tensor) else v
        assert np.array_equal(back[k], v)
        assert back[k].dtype == v.dtype


def test_latest_snapshot_orders_by_seq(tmp_path):
    for seq in (0, 1, 2):
        ckpt.write_snapshot(str(tmp_path), "lane", seq,
                            {"x": np.asarray([seq])}, {}, {})
    stem = ckpt.latest_snapshot(str(tmp_path), "lane")
    manifest, arrays = ckpt.read_snapshot(stem)
    assert manifest["seq"] == 2 and int(arrays["x"][0]) == 2


def test_prune_keeps_newest(tmp_path):
    for seq in range(5):
        ckpt.write_snapshot(str(tmp_path), "lane", seq,
                            {"x": np.asarray([seq])}, {}, {}, keep=2)
    seqs = [s for s, _ in ckpt.list_snapshots(str(tmp_path), "lane")]
    assert seqs == [3, 4]
    assert ckpt.KEEP_SNAPSHOTS == RC.KEEP_SNAPSHOTS == 2
    assert ckpt.DEFAULT_LANE_SUPERSTEPS == RC.DEFAULT_LANE_SUPERSTEPS == 4


def test_kinds_are_independent(tmp_path):
    ckpt.write_snapshot(str(tmp_path), "lane", 7, {"x": np.zeros(1)}, {}, {})
    assert ckpt.latest_snapshot(str(tmp_path), "stream") is None
    with pytest.raises(CheckpointError):
        ckpt.require_snapshot(str(tmp_path), "stream")


def test_crashed_write_commits_nothing(tmp_path):
    """An injected crash before the renames leaves no visible snapshot."""
    ckpt.write_snapshot(str(tmp_path), "lane", 0, {"x": np.asarray([1])},
                        {"gen": 0}, {})
    with faults.injected("checkpoint.write", times=1):
        with pytest.raises(InjectedFault):
            ckpt.write_snapshot(str(tmp_path), "lane", 1,
                                {"x": np.asarray([2])}, {"gen": 1}, {})
    manifest, arrays = ckpt.read_snapshot(
        ckpt.latest_snapshot(str(tmp_path), "lane"))
    assert manifest["meta"]["gen"] == 0 and int(arrays["x"][0]) == 1
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]


def _one_snapshot(tmp_path):
    return ckpt.write_snapshot(
        str(tmp_path), "lane", 0,
        {"x": np.arange(64, dtype=np.int64)}, {"root": 0}, {})


def test_bitflipped_npz_fails_crc(tmp_path):
    stem = _one_snapshot(tmp_path)
    data = bytearray(open(stem + ".npz", "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(stem + ".npz", "wb").write(bytes(data))
    with pytest.raises(CheckpointCorruptError):
        ckpt.read_snapshot(stem)


def test_truncated_npz_fails(tmp_path):
    stem = _one_snapshot(tmp_path)
    data = open(stem + ".npz", "rb").read()
    open(stem + ".npz", "wb").write(data[:len(data) // 3])
    with pytest.raises(CheckpointCorruptError):
        ckpt.read_snapshot(stem)


def test_missing_npz_fails(tmp_path):
    stem = _one_snapshot(tmp_path)
    os.unlink(stem + ".npz")
    with pytest.raises(CheckpointCorruptError):
        ckpt.read_snapshot(stem)


def test_garbage_manifest_fails(tmp_path):
    stem = _one_snapshot(tmp_path)
    open(stem + ".json", "w").write("{not json")
    with pytest.raises(CheckpointCorruptError):
        ckpt.read_snapshot(stem)


def test_wrong_version_fails_typed(tmp_path):
    stem = _one_snapshot(tmp_path)
    manifest = json.load(open(stem + ".json"))
    manifest["version"] = ckpt.SNAPSHOT_VERSION + 1
    json.dump(manifest, open(stem + ".json", "w"))
    with pytest.raises(CheckpointMismatchError) as ei:
        ckpt.read_snapshot(stem)
    assert ei.value.field == "version"


def test_wrong_kind_fails_typed(tmp_path):
    stem = _one_snapshot(tmp_path)
    with pytest.raises(CheckpointMismatchError) as ei:
        ckpt.read_snapshot(stem, kind="stream")
    assert ei.value.field == "kind"


def test_container_crosses_packages(tmp_path):
    """Either package reads the other's raw snapshots, CRCs and all."""
    arrays = {"a": np.arange(10, dtype=np.int32),
              "b": np.ones((2, 3), np.float32)}
    stem = ckpt.write_snapshot(str(tmp_path / "t"), "lane", 3, arrays,
                               {"k": 1}, {"graph": "x"})
    manifest, back = RC.read_snapshot(stem, kind="lane",
                                      expect={"graph": "x"})
    assert manifest["seq"] == 3
    stem = RC.write_snapshot(str(tmp_path / "r"), "lane", 4, arrays,
                             {"k": 2}, {"graph": "y"})
    manifest, back2 = ckpt.read_snapshot(stem, kind="lane",
                                         expect={"graph": "y"})
    assert manifest["meta"]["k"] == 2
    for k in arrays:
        assert np.array_equal(back[k], arrays[k])
        assert np.array_equal(back2[k], arrays[k])
    assert ckpt.array_crc32(arrays["b"]) == RC.array_crc32(arrays["b"])
    assert ckpt.array_crc32(torch.as_tensor(arrays["b"])) == \
        RC.array_crc32(arrays["b"])


# ---------------------------------------------------------------------------
# fingerprints: stable across calls, sensitive to every input
# ---------------------------------------------------------------------------


def test_fingerprints_stable(g):
    fa = ckpt.run_fingerprints(dsl.bfs_program(), g, ScheduleConfig())
    fb = ckpt.run_fingerprints(dsl.bfs_program(), g, ScheduleConfig())
    assert fa == fb


def test_graph_fingerprint_sensitive(g, g2):
    assert ckpt.fingerprint_graph(g) != ckpt.fingerprint_graph(g2)


def test_graph_fingerprint_equals_jax(g, rg):
    assert ckpt.fingerprint_graph(g) == RC.fingerprint_graph(rg)
    src, dst = _edges(300, 3000, 7)
    w = np.random.default_rng(3).uniform(0.5, 2.0, len(src)) \
        .astype(np.float32)
    assert ckpt.fingerprint_graph(G.from_edge_list(
        src, dst, weights=w, num_vertices=300)) == RC.fingerprint_graph(
        RG.from_edge_list(src, dst, weights=w, num_vertices=300))


def test_program_fingerprint_sensitive():
    fps = {ckpt.fingerprint_program(p) for p in (
        dsl.bfs_program(), dsl.sssp_program(), dsl.wcc_program())}
    assert len(fps) == 3


def test_program_fingerprint_sees_closure_params():
    """ppr(root=1) and ppr(root=2) differ only in captured constants."""
    a = ckpt.fingerprint_program(dsl.ppr_program(1))
    b = ckpt.fingerprint_program(dsl.ppr_program(2))
    assert a != b
    assert a == ckpt.fingerprint_program(dsl.ppr_program(1))


def test_program_fingerprint_hashes_torch_closures_by_content():
    """A tensor in a closure is hashed by its bytes and a torch builtin by
    its name: equal contents at other addresses fingerprint equal."""
    def prog(weights, fn):
        return dsl.VertexProgram(
            name="scaled", gather=lambda v, w, d: fn(v, weights[0]),
            reduce="min", apply=torch.minimum, init_value=0.0)
    a = ckpt.fingerprint_program(prog(torch.tensor([2.0]), torch.mul))
    b = ckpt.fingerprint_program(prog(torch.tensor([2.0]), torch.mul))
    c = ckpt.fingerprint_program(prog(torch.tensor([3.0]), torch.mul))
    d = ckpt.fingerprint_program(prog(torch.tensor([2.0]), torch.add))
    assert a == b and len({a, c, d}) == 3
    assert "0x" not in a


def test_schedule_fingerprint_sensitive():
    a = ckpt.fingerprint_schedule(ScheduleConfig())
    b = ckpt.fingerprint_schedule(
        ScheduleConfig(direction=DirectionPolicy(mode="push")))
    c = ckpt.fingerprint_schedule(ScheduleConfig(partitions=3))
    assert len({a, b, c}) == 3


@pytest.mark.parametrize("kw", [
    {}, {"direction": "push"}, {"pull_sweep": "bitmap"},
    {"backend": "sparse", "pipelines": 4}, {"max_supersteps": 9},
    {"probe_divergence": True, "block_rows": 64}])
def test_schedule_fingerprint_equals_jax(kw):
    def cfg(S):
        args = dict(kw)
        if "direction" in args:
            args["direction"] = S.DirectionPolicy(mode=args["direction"])
        return S.ScheduleConfig(**args)
    from repro_torch.core import scheduler as TS
    assert ckpt.fingerprint_schedule(cfg(TS)) == \
        RC.fingerprint_schedule(cfg(RS))


# ---------------------------------------------------------------------------
# lane round-trip through bytes, and across packages
# ---------------------------------------------------------------------------


def test_lane_snapshot_roundtrip_continues_bitexact(g, tmp_path):
    prog = translate(dsl.sssp_program(), g, ScheduleConfig(), device=CPU)
    ref, it_ref = prog.run(roots=0)
    state = prog.run_batch_slice(prog.batch_init([0]), 2)
    snap = prog.lane_snapshot(state)
    stem = ckpt.write_snapshot(str(tmp_path / "ck"), "lane", 0, snap, {}, {})
    _, arrays = ckpt.read_snapshot(stem)
    restored = prog.lane_restore(arrays)
    while not bool(prog.lane_done(restored)[0]):
        restored = prog.run_batch_slice(restored, 2)
    assert torch.equal(restored.values[0], ref)
    assert int(restored.iters[0]) == int(it_ref)


def test_lane_restore_missing_field_typed(g):
    prog = translate(dsl.bfs_program(), g, device=CPU)
    snap = prog.lane_snapshot(prog.batch_init([0]))
    snap.pop("pull_cost")
    with pytest.raises(CheckpointCorruptError) as ei:
        prog.lane_restore(snap)
    assert ei.value.member == "pull_cost"


@pytest.mark.parametrize("template", ["bfs", "sssp"])
def test_jax_lane_snapshot_restores_in_port(g, rg, tmp_path, template):
    """A mid-run JAX lane snapshot, read with the port's read_snapshot (no
    fingerprint expectation: programs differ by package) and restored,
    finishes equal to the JAX run_batch in values and lane_stats."""
    roots = np.asarray([0, 5, 17, 5])
    rprog = RT.translate(getattr(RD, f"{template}_program")(), rg,
                         RS.ScheduleConfig())
    tprog = translate(getattr(dsl, f"{template}_program")(), g,
                      ScheduleConfig(), device=CPU)
    ref_vals, ref_iters = rprog.run_batch(roots)
    ref_stats = rprog.last_run_stats
    rstate = rprog.run_batch_slice(rprog.batch_init(roots), 2)
    stem = RC.write_snapshot(str(tmp_path), "lane", 0,
                             rprog.lane_snapshot(rstate), {"from": "jax"},
                             RC.run_fingerprints(RD.bfs_program(), rg,
                                                 RS.ScheduleConfig()))
    manifest, arrays = ckpt.read_snapshot(stem, kind="lane")
    assert manifest["fingerprints"]["graph"] == ckpt.fingerprint_graph(g)
    assert manifest["fingerprints"]["schedule"] == \
        ckpt.fingerprint_schedule(ScheduleConfig())
    state = tprog.lane_restore(arrays)
    while not tprog.lane_done(state).all():
        state = tprog.run_batch_slice(state, 3)
    np.testing.assert_array_equal(state.values.numpy(), np.asarray(ref_vals))
    np.testing.assert_array_equal(state.iters, np.asarray(ref_iters))
    stats = tprog.lane_stats(state)
    for k in ref_stats:
        assert stats[k] == ref_stats[k], k


def test_port_lane_snapshot_restores_in_jax(g, rg, tmp_path):
    roots = np.asarray([0, 9, 17])
    tprog = translate(dsl.bfs_program(), g, ScheduleConfig(), device=CPU)
    rprog = RT.translate(RD.bfs_program(), rg, RS.ScheduleConfig())
    ref_vals, ref_iters = tprog.run_batch(roots)
    tstate = tprog.run_batch_slice(tprog.batch_init(roots), 2)
    stem = ckpt.write_snapshot(str(tmp_path), "lane", 0,
                               tprog.lane_snapshot(tstate), {},
                               ckpt.run_fingerprints(dsl.bfs_program(), g,
                                                     ScheduleConfig()))
    manifest, arrays = RC.read_snapshot(stem, kind="lane")
    rstate = rprog.lane_restore(arrays)
    while not rprog.lane_done(rstate).all():
        rstate = rprog.run_batch_slice(rstate, 3)
    np.testing.assert_array_equal(np.asarray(rstate.values),
                                  ref_vals.numpy())
    np.testing.assert_array_equal(np.asarray(rstate.iters),
                                  ref_iters.numpy())
    # a program fingerprint the restoring run does not have refuses
    with pytest.raises(CheckpointMismatchError) as ei:
        ckpt.read_snapshot(stem, expect=ckpt.run_fingerprints(
            dsl.sssp_program(), g, ScheduleConfig()))
    assert ei.value.field == "program"


# ---------------------------------------------------------------------------
# mismatch surfaces on resume: wrong inputs never resume silently
# ---------------------------------------------------------------------------


def _checkpointed_run(source, tmp_path, **kw):
    prog = translate(dsl.bfs_program(), source, ScheduleConfig(),
                     device=CPU, **kw)
    prog.run(roots=0, checkpoint_dir=str(tmp_path / "ck"),
             checkpoint_every=1)
    return prog


def test_resume_against_wrong_graph(g, g2, tmp_path):
    _checkpointed_run(g, tmp_path)
    other = translate(dsl.bfs_program(), g2, ScheduleConfig(), device=CPU)
    with pytest.raises(CheckpointMismatchError) as ei:
        other.run(roots=0, checkpoint_dir=str(tmp_path / "ck"),
                  checkpoint_every=1, resume=True)
    assert ei.value.field == "graph"


def test_resume_against_wrong_program(g, tmp_path):
    _checkpointed_run(g, tmp_path)
    other = translate(dsl.sssp_program(), g, ScheduleConfig(), device=CPU)
    with pytest.raises(CheckpointMismatchError) as ei:
        other.run(roots=0, checkpoint_dir=str(tmp_path / "ck"),
                  checkpoint_every=1, resume=True)
    assert ei.value.field == "program"


def test_resume_against_wrong_schedule(g, tmp_path):
    _checkpointed_run(g, tmp_path)
    other = translate(dsl.bfs_program(), g,
                      ScheduleConfig(direction=DirectionPolicy(mode="push")),
                      device=CPU)
    with pytest.raises(CheckpointMismatchError) as ei:
        other.run(roots=0, checkpoint_dir=str(tmp_path / "ck"),
                  checkpoint_every=1, resume=True)
    assert ei.value.field == "schedule"


def test_resume_against_wrong_root(g, tmp_path):
    prog = _checkpointed_run(g, tmp_path)
    with pytest.raises(CheckpointMismatchError) as ei:
        prog.run(roots=5, checkpoint_dir=str(tmp_path / "ck"),
                 checkpoint_every=1, resume=True)
    assert ei.value.field == "root"


def test_resume_from_bitflipped_snapshot(g, tmp_path):
    _checkpointed_run(g, tmp_path)
    stem = ckpt.latest_snapshot(str(tmp_path / "ck"), "lane")
    data = bytearray(open(stem + ".npz", "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(stem + ".npz", "wb").write(bytes(data))
    prog = translate(dsl.bfs_program(), g, ScheduleConfig(), device=CPU)
    with pytest.raises(CheckpointCorruptError):
        prog.run(roots=0, checkpoint_dir=str(tmp_path / "ck"),
                 checkpoint_every=1, resume=True)


def test_checkpointing_requires_translate_fingerprints(g):
    prog = translate(dsl.bfs_program(), g, device=CPU)
    assert prog._fingerprints()            # translate() wires them
    bare = CompiledGraphProgram.__new__(CompiledGraphProgram)
    bare._fingerprints_cache = None
    bare._fingerprints_fn = None
    with pytest.raises(ValueError):
        bare._fingerprints()


def test_translate_time_checkpoint_defaults(g, tmp_path):
    """translate(checkpoint_dir=, checkpoint_every=) are run()'s
    defaults."""
    ck = str(tmp_path / "ck")
    prog = translate(dsl.bfs_program(), g, ScheduleConfig(), device=CPU,
                     checkpoint_dir=ck, checkpoint_every=2)
    v, it = prog.run(roots=0)
    st = prog.last_run_stats
    assert st["checkpoint_saves"] == -(-it // 2)
    assert st["checkpoint_loads"] == 0 and st["checkpoint_write_s"] >= 0
    assert ckpt.latest_snapshot(ck, "lane") is not None


# ---------------------------------------------------------------------------
# crash-anywhere recovery (resident plane)
# ---------------------------------------------------------------------------


PROGRAMS = {"bfs": (dsl.bfs_program, RD.bfs_program),
            "sssp": (dsl.sssp_program, RD.sssp_program),
            "wcc": (dsl.wcc_program, RD.wcc_program)}
CRASH_ROOTS = {"bfs": 0, "sssp": 0, "wcc": None}


def _translate(template, source, mode):
    return translate(PROGRAMS[template][0](), source,
                     ScheduleConfig(direction=DirectionPolicy(mode=mode)),
                     device=CPU)


@pytest.mark.parametrize("mode", ["pull", "push", "auto"])
@pytest.mark.parametrize("template", ["bfs", "sssp", "wcc"])
def test_crash_resume_bitexact(gc, tmp_path, template, mode):
    """Killed at an armed lane.crash and resumed in a fresh translate:
    values, iters and counters equal an uninterrupted run's, and the JAX
    package's run for the same inputs."""
    root = CRASH_ROOTS[template]
    oracle = _translate(template, gc, mode)
    v_ref, it_ref = oracle.run(roots=root)
    oref = oracle.last_run_stats

    ck = str(tmp_path / "ck")
    crashed = _translate(template, gc, mode)
    with faults.injected("lane.crash", times=1, after=2) as plan:
        with pytest.raises(InjectedFault):
            crashed.run(roots=root, checkpoint_dir=ck, checkpoint_every=1)
    assert plan.fired == 1

    has_snap = ckpt.latest_snapshot(ck, "lane") is not None
    resumed = _translate(template, gc, mode)
    v, it = resumed.run(roots=root, checkpoint_dir=ck, checkpoint_every=1,
                        resume=True)
    assert torch.equal(v, v_ref)
    assert int(it) == int(it_ref)
    st = resumed.last_run_stats
    assert st["checkpoint_loads"] == (1 if has_snap else 0)
    for key in ("push_supersteps", "pull_supersteps", "direction_switches",
                "edges_traversed", "pull_cost_model", "terminated"):
        assert st[key] == oref[key], key
    src, dst = _edges(500, 4000, 5)
    ref = RT.translate(PROGRAMS[template][1](),
                       RG.from_edge_list(src, dst, num_vertices=500),
                       RS.ScheduleConfig(direction=RS.DirectionPolicy(
                           mode=mode)))
    rv, rit = ref.run(roots=root)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    assert int(rit) == int(it)


def test_resident_crash_at_every_boundary(gc, tmp_path):
    """Kill one bfs run at each of its slice boundaries in turn, resume
    each time: every resume ends equal to the uninterrupted run."""
    oracle = _translate("bfs", gc, "auto")
    v_ref, it_ref = oracle.run(roots=0)
    probe = _translate("bfs", gc, "auto")
    plan = faults.arm("lane.crash", times=0)
    probe.run(roots=0, checkpoint_dir=str(tmp_path / "probe"),
              checkpoint_every=1)
    trips = plan.calls
    faults.reset()
    assert trips >= 3
    for after in range(trips):
        ck = str(tmp_path / f"ck{after}")
        with faults.injected("lane.crash", times=1, after=after):
            with pytest.raises(InjectedFault):
                _translate("bfs", gc, "auto").run(
                    roots=0, checkpoint_dir=ck, checkpoint_every=1)
        resumed = _translate("bfs", gc, "auto")
        v, it = resumed.run(roots=0, checkpoint_dir=ck, checkpoint_every=1,
                            resume=True)
        assert torch.equal(v, v_ref), f"crash at trip {after}"
        assert int(it) == int(it_ref)


def test_crash_during_checkpoint_write(gc, tmp_path):
    """A crash mid-write never poisons recovery: the previous snapshot
    (or a fresh start) still resumes to the exact answer."""
    ref, it_ref = translate(dsl.bfs_program(), gc, device=CPU).run(roots=0)
    ck = str(tmp_path / "ck")
    prog = translate(dsl.bfs_program(), gc, ScheduleConfig(), device=CPU)
    with faults.injected("checkpoint.write", times=1, after=1):
        with pytest.raises(InjectedFault):
            prog.run(roots=0, checkpoint_dir=ck, checkpoint_every=1)
    resumed = translate(dsl.bfs_program(), gc, ScheduleConfig(), device=CPU)
    v, it = resumed.run(roots=0, checkpoint_dir=ck, checkpoint_every=1,
                        resume=True)
    assert torch.equal(v, ref)
    assert int(it) == int(it_ref)


def test_resume_without_snapshot_runs_fresh(gc, tmp_path):
    """resume=True with an empty directory is a cold start, not an error."""
    ref, it_ref = translate(dsl.bfs_program(), gc, device=CPU).run(roots=0)
    prog = translate(dsl.bfs_program(), gc, ScheduleConfig(), device=CPU)
    v, it = prog.run(roots=0, checkpoint_dir=str(tmp_path / "empty"),
                     checkpoint_every=2, resume=True)
    assert torch.equal(v, ref)
    assert int(it) == int(it_ref)
    assert prog.last_run_stats["checkpoint_loads"] == 0


# ---------------------------------------------------------------------------
# serving plane: rolling restart
# ---------------------------------------------------------------------------


def _server(g, **kw):
    return GraphServer(g, schedule=ScheduleConfig(),
                       admission=AdmissionPolicy(slots=4,
                                                 slice_supersteps=2),
                       landmarks=3, device=CPU, **kw)


SPECS = [("bfs", 0, None), ("sssp", 5, None), ("bfs", 11, None),
         ("dist", 3, 17), ("ppr", 2, None), ("bfs", 0, None),
         ("sssp", 40, None), ("dist", 8, 499), ("bfs", 77, None)]


def _oracle_answers(g):
    srv = _server(g)
    qs = [srv.submit(k, r, target=t) for k, r, t in SPECS]
    srv.run()
    return qs


def _assert_served(oracle, qs, srv, fresh):
    by_qid = {q.qid: q for q in srv.done if q.done}
    for q in fresh.done:
        by_qid[q.qid] = q
    for o, s in zip(oracle, qs):
        got = by_qid.get(s.qid)
        assert got is not None and got.done, f"qid {s.qid} never served"
        if isinstance(o.result, np.ndarray):
            assert np.array_equal(got.result, o.result), (s.qid, o.kind)
        else:
            assert got.result == o.result, (s.qid, o.kind)
        assert got.iters == o.iters


@pytest.mark.parametrize("steps_before_kill", [0, 1, 3])
def test_server_rolling_restart_bitexact(gc, tmp_path, steps_before_kill):
    oracle = _oracle_answers(gc)
    srv = _server(gc)
    qs = [srv.submit(k, r, target=t) for k, r, t in SPECS]
    for _ in range(steps_before_kill):
        srv.step()
    assert srv.snapshot(str(tmp_path))
    fresh = _server(gc)
    fresh.restore(str(tmp_path))
    fresh.run()
    _assert_served(oracle, qs, srv, fresh)


def test_server_killed_mid_serve_restarts(gc, tmp_path):
    """An armed lane.crash kills step(); snapshot + restore re-serves
    every pending query bit-equal to the uninterrupted oracle."""
    oracle = _oracle_answers(gc)
    srv = _server(gc)
    qs = [srv.submit(k, r, target=t) for k, r, t in SPECS]
    with faults.injected("lane.crash", times=1, after=1):
        with pytest.raises(InjectedFault):
            while srv.step():
                pass
    srv.snapshot(str(tmp_path))
    fresh = _server(gc)
    fresh.restore(str(tmp_path))
    fresh.run()
    _assert_served(oracle, qs, srv, fresh)


def test_server_restore_rejects_wrong_config(gc, tmp_path):
    srv = _server(gc)
    srv.submit("bfs", 0)
    srv.step()
    srv.snapshot(str(tmp_path))
    other = GraphServer(
        gc, schedule=ScheduleConfig(direction=DirectionPolicy(mode="push")),
        admission=AdmissionPolicy(slots=4, slice_supersteps=2), landmarks=3,
        device=CPU)
    with pytest.raises(CheckpointMismatchError) as ei:
        other.restore(str(tmp_path))
    assert ei.value.field == "schedule"
    other = _server(gc)
    other.admission = AdmissionPolicy(slots=2, slice_supersteps=2)
    with pytest.raises(CheckpointMismatchError) as ei:
        other.restore(str(tmp_path))
    assert ei.value.field == "admission"
    src, dst = _edges(500, 4000, 99)
    other = _server(G.from_edge_list(src, dst, num_vertices=500))
    with pytest.raises(CheckpointMismatchError) as ei:
        other.restore(str(tmp_path))
    assert ei.value.field == "graph"
    busy = _server(gc)
    busy.submit("bfs", 1)
    with pytest.raises(CheckpointError):
        busy.restore(str(tmp_path))


def test_server_snapshot_rejects_custom_program(gc, tmp_path):
    srv = _server(gc)
    custom = dataclasses.replace(dsl.sssp_program(), name="custom-sssp")
    srv.submit("sssp", 0, program=custom)
    with pytest.raises(CheckpointError):
        srv.snapshot(str(tmp_path))


# ---------------------------------------------------------------------------
# the fault registry (tests/test_faults.py's registry cases)
# ---------------------------------------------------------------------------


def test_injection_points_match_jax():
    from repro.core import faults as RF
    assert faults.INJECTION_POINTS == RF.INJECTION_POINTS


def test_unknown_point_rejected():
    with pytest.raises(ValueError, match="unknown injection point"):
        faults.arm("no.such.point")


def test_trip_unarmed_is_identity():
    payload = {"dst": np.arange(4, dtype=np.int32)}
    assert faults.trip("container.read", payload) is payload
    faults.trip("lane.superstep")            # no payload: silently nothing


def test_times_and_after_window():
    plan = faults.arm("lane.superstep", times=2, after=1)
    faults.trip("lane.superstep")                       # call 1: warm-up
    for _ in range(2):                                  # calls 2-3: fire
        with pytest.raises(errors.InjectedFault):
            faults.trip("lane.superstep")
    faults.trip("lane.superstep")                       # call 4: exhausted
    assert plan.calls == 4 and plan.fired == 2
    assert faults.fired("lane.superstep") == 2
    assert faults.calls("lane.superstep") == 4


def test_rate_mode_is_seed_deterministic():
    def fire_pattern(seed):
        faults.reset()
        faults.arm("lane.superstep", rate=0.5, times=10 ** 9, seed=seed)
        pat = []
        for _ in range(32):
            try:
                faults.trip("lane.superstep")
                pat.append(0)
            except errors.InjectedFault:
                pat.append(1)
        return pat

    assert fire_pattern(7) == fire_pattern(7)
    assert fire_pattern(7) != fire_pattern(8)
    assert 0 < sum(fire_pattern(7)) < 32


def test_injected_context_disarms_on_exit():
    with faults.injected("container.read", mode="corrupt") as plan:
        assert faults.active() == ("container.read",)
        faults.trip("container.read", {"dst": np.zeros(8, np.int32)})
        assert plan.fired == 1
    assert faults.active() == ()


def test_corrupt_mode_flips_exactly_one_element():
    clean = {"offsets": np.arange(5, dtype=np.int64),
             "dst": np.arange(16, dtype=np.int32)}
    faults.arm("container.read", mode="corrupt")
    got = faults.trip("container.read", dict(clean))
    assert np.array_equal(got["offsets"], clean["offsets"])
    diff = got["dst"] != clean["dst"]
    assert diff.sum() == 1
    assert int(np.abs(got["dst"][diff] ^ clean["dst"][diff])[0]) == 1


def test_injected_fault_is_transient_and_typed():
    assert issubclass(errors.InjectedFault, errors.TransientFault)
    assert issubclass(errors.TransientFault, errors.ReproError)


def test_serving_slice_fault_raises_typed(g):
    srv = GraphServer(g, device=CPU)
    q = srv.submit("bfs", root=0)
    with faults.injected("lane.superstep"):
        with pytest.raises(errors.InjectedFault):
            srv.run()
    # the fault left the query unanswered, not wrongly answered
    assert not q.done
    faults.reset()
    srv.run()
    assert q.done and q.answer_quality == "exact"
