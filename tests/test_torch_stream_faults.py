"""Port parity: the streamed engine's fault tolerance, on the CPU.

Case for case with the streamed cases of ``tests/test_faults.py``
(prefetch retries, checksum recovery, a poisoned superstep),
``tests/test_crash_recovery.py`` (crash and resume at every boundary,
recovery counters across a crash), ``tests/test_robustness.py`` (the
superstep budget, v2 checksums, tampering, v1 containers, the store's
floor) and ``tests/test_checkpoint.py`` (container fingerprints, the
streamed lane round trip, mismatch surfaces).  Each case runs the JAX
package's streamed engine beside the port's on the same container, and
containers, fingerprints and streamed lane snapshots cross the packages
both ways.
"""
import signal

import numpy as np
import pytest

import repro.core  # noqa: F401  (import order: core before kernels)
from repro import errors as rerrors
from repro.core import checkpoint as RC
from repro.core import dsl as RD
from repro.core import faults as RF
from repro.core import graph as RG
from repro.core import scheduler as RS
from repro.core.comm import CommManager as RComm
from repro.core.preprocess import PartitionStore as RStore
from repro.core.translator import translate as rtranslate
from repro.data import graphs as RDATA

import torch
from repro_torch import errors
from repro_torch.core import checkpoint as ckpt
from repro_torch.core import dsl
from repro_torch.core import faults
from repro_torch.core import graph as G
from repro_torch.core.comm import CommManager
from repro_torch.core.preprocess import PartitionStore
from repro_torch.core.scheduler import DirectionPolicy, ScheduleConfig
from repro_torch.core.translator import translate
from repro_torch.data import graphs as D
from torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.chaos

CPU = "cpu"
TIMEOUT_S = 300
PROGRAMS = {"bfs": (RD.bfs_program, dsl.bfs_program),
            "sssp": (RD.sssp_program, dsl.sssp_program),
            "wcc": (RD.wcc_program, dsl.wcc_program)}
ROOTS = {"bfs": 0, "sssp": 0, "wcc": None}


@pytest.fixture(autouse=True)
def _no_hang_and_clean_registry():
    """SIGALRM watchdog (no test may hang) + pristine fault registries."""
    faults.reset()
    RF.reset()

    def _alarm(signum, frame):
        raise AssertionError(f"stream fault test hung (> {TIMEOUT_S}s)")

    old = signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        faults.reset()
        RF.reset()


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(4)
    src, dst = RG.rmat_edges(800, 6400, seed=5)
    w = rng.uniform(0.5, 3.0, len(src)).astype(np.float32)
    return (RG.from_edge_list(src, dst, weights=w, num_vertices=800),
            G.from_edge_list(src, dst, weights=w, num_vertices=800))


@pytest.fixture(scope="module")
def container(graphs, tmp_path_factory):
    """One container, written by the port, that both packages read."""
    path = str(tmp_path_factory.mktemp("chaos") / "c.npz")
    D.container_from_graph(path, graphs[1], 3)
    return path


def _stream(path, template="bfs", mode="push", *, jax=False):
    """The template's streamed run over ``path`` in one package: values,
    iters, stats."""
    if jax:
        prog = rtranslate(PROGRAMS[template][0](),
                          RDATA.load_partition_container(path),
                          RS.ScheduleConfig(
                              direction=RS.DirectionPolicy(mode=mode)),
                          RComm())
    else:
        prog = translate(PROGRAMS[template][1](),
                         D.load_partition_container(path),
                         ScheduleConfig(direction=DirectionPolicy(mode=mode)),
                         CommManager(), device=CPU)
    prog._retry_base_s = 0.0              # keep chaos tests fast
    values, iters = prog.run(roots=ROOTS[template])
    return np.asarray(values), int(iters), prog.last_run_stats


# ---------------------------------------------------------------------------
# prefetch.device_put: transient copy failures retry with backoff
# ---------------------------------------------------------------------------


def test_prefetch_transient_fault_recovers_bit_equal(container):
    base, _, _ = _stream(container)
    with faults.injected("prefetch.device_put", times=2) as plan:
        values, _, stats = _stream(container)
    with RF.injected("prefetch.device_put", times=2):
        rvalues, _, rstats = _stream(container, jax=True)
    assert plan.fired == 2
    assert stats["partition_retries"] == rstats["partition_retries"] == 2
    assert stats["partition_corruptions"] == 0
    assert stats["terminated"] == rstats["terminated"] == "converged"
    np.testing.assert_array_equal(values, base)
    np.testing.assert_array_equal(values, rvalues)


def test_prefetch_persistent_fault_raises_typed(container):
    with faults.injected("prefetch.device_put", times=10 ** 6):
        with pytest.raises(errors.StreamRetryError) as ei:
            _stream(container)
    with RF.injected("prefetch.device_put", times=10 ** 6):
        with pytest.raises(rerrors.StreamRetryError) as rei:
            _stream(container, jax=True)
    assert ei.value.attempts == rei.value.attempts == 4
    assert ei.value.partition == rei.value.partition >= 0
    assert isinstance(ei.value, errors.ReproError)


# ---------------------------------------------------------------------------
# container.read: corruption caught by the CRC, rebuilt once
# ---------------------------------------------------------------------------


def test_container_corruption_recovers_via_rebuild(container):
    base, _, _ = _stream(container)
    with faults.injected("container.read", mode="corrupt", times=1) as plan:
        values, _, stats = _stream(container)
    with RF.injected("container.read", mode="corrupt", times=1):
        _, _, rstats = _stream(container, jax=True)
    assert plan.fired == 1
    assert stats["partition_corruptions"] == \
        rstats["partition_corruptions"] == 1
    assert stats["terminated"] == "converged"
    np.testing.assert_array_equal(values, base)


def test_container_persistent_corruption_raises_checksum(container):
    with faults.injected("container.read", mode="corrupt", times=10 ** 6):
        with pytest.raises(errors.ChecksumError) as ei:
            _stream(container)
    with RF.injected("container.read", mode="corrupt", times=10 ** 6):
        with pytest.raises(rerrors.ChecksumError) as rei:
            _stream(container, jax=True)
    assert ei.value.partition is not None
    assert ei.value.partition == rei.value.partition


# ---------------------------------------------------------------------------
# lane.superstep: a poisoned superstep fails typed, never hangs
# ---------------------------------------------------------------------------


def test_streamed_superstep_fault_raises_typed(container):
    with faults.injected("lane.superstep", after=1) as plan:
        with pytest.raises(errors.InjectedFault):
            _stream(container)
    assert plan.fired == 1
    faults.reset()
    base, _, _ = _stream(container)             # disarmed: runs clean
    rbase, _, _ = _stream(container, jax=True)
    np.testing.assert_array_equal(base, rbase)


# ---------------------------------------------------------------------------
# crash anywhere, resume bit-exactly
# ---------------------------------------------------------------------------


def _translate(template, path, mode):
    prog = translate(PROGRAMS[template][1](),
                     D.load_partition_container(path),
                     ScheduleConfig(direction=DirectionPolicy(mode=mode)),
                     CommManager(), device=CPU)
    prog._retry_base_s = 0.0
    return prog


@pytest.mark.parametrize("mode", ["pull", "push", "auto"])
@pytest.mark.parametrize("template", ["bfs", "sssp", "wcc"])
def test_crash_resume_bitexact(container, tmp_path, template, mode):
    root = ROOTS[template]
    oracle = _translate(template, container, mode)
    v_ref, it_ref = oracle.run(roots=root)
    oref = oracle.last_run_stats
    _, rit, rstats = _stream(container, template, mode, jax=True)
    assert rit == it_ref
    ck = str(tmp_path / "ck")
    crashed = _translate(template, container, mode)
    with faults.injected("lane.crash", times=1, after=2) as plan:
        with pytest.raises(errors.InjectedFault):
            crashed.run(roots=root, checkpoint_dir=ck, checkpoint_every=1)
    assert plan.fired == 1
    has_snap = ckpt.latest_snapshot(ck, "stream") is not None
    resumed = _translate(template, container, mode)
    v, it = resumed.run(roots=root, checkpoint_dir=ck, checkpoint_every=1,
                        resume=True)
    np.testing.assert_array_equal(v.numpy(), v_ref.numpy())
    assert it == it_ref
    st = resumed.last_run_stats
    assert st["checkpoint_loads"] == (1 if has_snap else 0)
    for key in ("push_supersteps", "pull_supersteps", "direction_switches",
                "edges_traversed", "pull_cost_model", "terminated",
                "partitions_swept", "partitions_skipped",
                "partition_retries", "partition_corruptions"):
        assert st[key] == oref[key] == rstats[key], key


def test_streamed_crash_at_every_boundary(container, tmp_path):
    """Kill a streamed bfs at each of its ``lane.crash`` points (every
    superstep and every partition boundary), resume each time; the port
    trips the points the JAX package trips."""
    oracle = _translate("bfs", container, "auto")
    v_ref, it_ref = oracle.run(roots=0)
    probe = _translate("bfs", container, "auto")
    plan = faults.arm("lane.crash", times=0)
    probe.run(roots=0, checkpoint_dir=str(tmp_path / "probe"),
              checkpoint_every=1)
    trips = plan.calls
    faults.reset()
    rprobe = rtranslate(RD.bfs_program(),
                        RDATA.load_partition_container(container),
                        RS.ScheduleConfig(), RComm())
    rplan = RF.arm("lane.crash", times=0)
    rprobe.run(roots=0, checkpoint_dir=str(tmp_path / "rprobe"),
               checkpoint_every=1)
    assert rplan.calls == trips > 4
    RF.reset()
    for after in range(trips):
        ck = str(tmp_path / f"ck{after}")
        crashed = _translate("bfs", container, "auto")
        with faults.injected("lane.crash", times=1, after=after):
            with pytest.raises(errors.InjectedFault):
                crashed.run(roots=0, checkpoint_dir=ck, checkpoint_every=1)
        resumed = _translate("bfs", container, "auto")
        v, it = resumed.run(roots=0, checkpoint_dir=ck, checkpoint_every=1,
                            resume=True)
        np.testing.assert_array_equal(v.numpy(), v_ref.numpy(),
                                      err_msg=f"crash at trip {after}")
        assert it == it_ref


def test_recovery_counters_survive_crash(container, tmp_path):
    with faults.injected("container.read", mode="corrupt", times=1):
        oracle = _translate("bfs", container, "pull")
        v_ref, _ = oracle.run(roots=0)
    assert oracle.last_run_stats["partition_corruptions"] == 1
    ck = str(tmp_path / "ck")
    faults.arm("container.read", mode="corrupt", times=1)
    faults.arm("lane.crash", times=1, after=4)
    crashed = _translate("bfs", container, "pull")
    with pytest.raises(errors.InjectedFault):
        crashed.run(roots=0, checkpoint_dir=ck, checkpoint_every=1)
    faults.reset()
    resumed = _translate("bfs", container, "pull")
    v, _ = resumed.run(roots=0, checkpoint_dir=ck, checkpoint_every=1,
                       resume=True)
    np.testing.assert_array_equal(v.numpy(), v_ref.numpy())
    st = resumed.last_run_stats
    assert st["partition_corruptions"] == 1
    assert st["checkpoint_loads"] == 1


# ---------------------------------------------------------------------------
# bounded supersteps; checksummed containers; the store's floor
# ---------------------------------------------------------------------------


def _oscillator(pkg):
    """Adversarial program: apply flips the sign forever, every vertex
    active."""
    return pkg.VertexProgram(name="oscillator", gather=lambda v, w, d: v,
                             reduce="add", apply=lambda old, s: -old,
                             init_value=1.0, frontier="all",
                             mask_inactive=False)


def test_oscillator_terminates_budget_streamed(graphs, container):
    prog = translate(_oscillator(dsl), D.load_partition_container(container),
                     ScheduleConfig(max_supersteps=6), CommManager(),
                     device=CPU)
    values, iters = prog.run()
    assert iters == 6
    assert prog.last_run_stats["terminated"] == "budget"
    np.testing.assert_array_equal(values.numpy(),
                                  np.ones(graphs[1].num_vertices,
                                          np.float32))
    rprog = rtranslate(_oscillator(RD),
                       RDATA.load_partition_container(container),
                       RS.ScheduleConfig(max_supersteps=6), RComm())
    rvalues, _ = rprog.run()
    np.testing.assert_array_equal(values.numpy(), np.asarray(rvalues))


def test_container_v2_roundtrip_and_verify(graphs, tmp_path):
    path = D.container_from_graph(str(tmp_path / "c.npz"), graphs[1], 4)
    c = D.load_partition_container(path)
    assert c.version == D.CONTAINER_VERSION == RDATA.CONTAINER_VERSION == 2
    assert c.checksums is not None and len(c.checksums) == 4
    c.verify()
    RDATA.load_partition_container(path).verify()


def test_container_tamper_detected(graphs, tmp_path):
    path = RDATA.container_from_graph(str(tmp_path / "c.npz"), graphs[0], 3)
    members = dict(np.load(path))
    members["p1_dst"] = members["p1_dst"].copy()
    members["p1_dst"][0] ^= 1                  # one bit flipped
    np.savez(path, **members)
    c = D.load_partition_container(path)
    c.partition_coo(0)                         # untampered partitions fine
    with pytest.raises(errors.ChecksumError, match="partition 1"):
        c.partition_coo(1)
    with pytest.raises(errors.ChecksumError):
        c.verify()
    # a streamed run re-reads once, then raises the typed error
    prog = translate(dsl.bfs_program(), c, ScheduleConfig(), CommManager(),
                     device=CPU)
    with pytest.raises(errors.ChecksumError):
        prog.run(roots=int(c.cuts[1]))
    assert prog._comm.stats.partition_corruptions == 1
    # an id out of range: translate(validate=True) names the partition in
    # either package, before any superstep runs
    members["p1_dst"][0] = c.num_vertices
    np.savez(path, **members)
    with pytest.raises(errors.GraphValidationError, match="partition 1"):
        translate(dsl.bfs_program(), D.load_partition_container(path),
                  ScheduleConfig(), device=CPU, validate=True)
    with pytest.raises(rerrors.GraphValidationError, match="partition 1"):
        rtranslate(RD.bfs_program(), RDATA.load_partition_container(path),
                   RS.ScheduleConfig(), validate=True)


def test_container_v1_backcompat(graphs, tmp_path):
    path = D.container_from_graph(str(tmp_path / "c.npz"), graphs[1], 3)
    members = dict(np.load(path))
    del members["checksums"]
    meta = members["meta"].copy()
    meta[0] = 1
    members["meta"] = meta
    np.savez(path, **members)
    c = D.load_partition_container(path)       # v1: loads, no verify
    assert c.version == 1 and c.checksums is None
    _, dst, _ = c.partition_coo(1)
    assert dst.size > 0
    rc = RDATA.load_partition_container(path)
    assert rc.version == 1
    assert ckpt.fingerprint_graph(c) == RC.fingerprint_graph(rc)
    v, _ = translate(dsl.bfs_program(), c, ScheduleConfig(),
                     device=CPU).run(roots=0)
    base, _ = translate(dsl.bfs_program(), graphs[1], device=CPU).run(roots=0)
    np.testing.assert_array_equal(v.numpy(), base.numpy())


def test_container_single_partition(graphs, tmp_path):
    path = D.container_from_graph(str(tmp_path / "c.npz"), graphs[1], 1)
    c = D.load_partition_container(path)
    assert c.partitions == 1
    c.verify()
    base, _ = translate(dsl.bfs_program(), graphs[1], device=CPU).run(roots=0)
    prog = translate(dsl.bfs_program(), c, ScheduleConfig(), CommManager(),
                     device=CPU)
    values, _ = prog.run(roots=0)
    np.testing.assert_array_equal(values.numpy(), base.numpy())


def test_store_budget_below_double_buffer_floor(graphs):
    rg, g = graphs
    cuts = G.edge_interval_cuts(g.out_degrees.numpy(), 4)
    store = PartitionStore(g, cuts, max_bytes=1)
    rstore = RStore(rg, cuts, max_bytes=1)
    for p in range(4):
        store.push_arrays(p)
        rstore.push_arrays(p)
        assert 1 <= len(store._cache) <= 2
        assert len(store._cache) == len(rstore._cache)
    assert store.evictions == rstore.evictions > 0
    base, _ = translate(dsl.bfs_program(), g, device=CPU).run(roots=0)
    prog = translate(dsl.bfs_program(), g,
                     ScheduleConfig(partitions=4, partition_budget_bytes=1),
                     CommManager(), device=CPU)
    values, _ = prog.run(roots=0)
    np.testing.assert_array_equal(values.numpy(), base.numpy())


def test_store_evict_partition(graphs):
    cuts = G.edge_interval_cuts(graphs[1].out_degrees.numpy(), 3)
    store = PartitionStore(graphs[1], cuts)
    store.push_arrays(1)
    store.pull_arrays(1)
    assert store.evict_partition(1) == 2
    assert store.evict_partition(1) == 0       # idempotent
    store.push_arrays(1)                       # rebuilds cleanly
    assert store.builds == 3


# ---------------------------------------------------------------------------
# fingerprints and streamed lane snapshots across the packages
# ---------------------------------------------------------------------------


def test_container_fingerprint_distinct_and_equal_to_jax(graphs, tmp_path):
    p3 = D.load_partition_container(
        D.container_from_graph(str(tmp_path / "c3.npz"), graphs[1], 3))
    p2 = D.load_partition_container(
        D.container_from_graph(str(tmp_path / "c2.npz"), graphs[1], 2))
    assert ckpt.fingerprint_graph(p3) != ckpt.fingerprint_graph(p2)
    again = D.load_partition_container(str(tmp_path / "c3.npz"))
    assert ckpt.fingerprint_graph(p3) == ckpt.fingerprint_graph(again)
    r3 = RDATA.load_partition_container(str(tmp_path / "c3.npz"))
    assert ckpt.fingerprint_graph(p3) == RC.fingerprint_graph(r3)
    assert ckpt.fingerprint_schedule(ScheduleConfig(partitions=3)) == \
        RC.fingerprint_schedule(RS.ScheduleConfig(partitions=3))
    assert ckpt.DEFAULT_STREAM_SWEEPS == RC.DEFAULT_STREAM_SWEEPS


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_streamed_lane_snapshot_crosses_packages(container, tmp_path,
                                                 writer):
    """A streamed lane snapshot taken mid-run by one package, written
    through the snapshot container, restores in the other and finishes
    equal to an uncut run, counters and all."""
    rprog = rtranslate(RD.sssp_program(),
                       RDATA.load_partition_container(container),
                       RS.ScheduleConfig(), RComm())
    tprog = translate(dsl.sssp_program(), D.load_partition_container(container),
                      ScheduleConfig(), CommManager(), device=CPU)
    ref = rprog.run_batch([0, 7])
    src, dst = (tprog, rprog) if writer == "port" else (rprog, tprog)
    state = src.run_batch_slice(src.batch_init([0, 7]), 2)
    write = ckpt.write_snapshot if writer == "port" else RC.write_snapshot
    read = RC.read_snapshot if writer == "port" else ckpt.read_snapshot
    stem = write(str(tmp_path / "ck"), "stream", 0, src.lane_snapshot(state),
                 {}, {})
    _, arrays = read(stem, kind="stream")
    restored = dst.lane_restore(arrays)
    while not dst.lane_done(restored).all():
        restored = dst.run_batch_slice(restored, 2)
    np.testing.assert_array_equal(np.asarray(restored.values),
                                  np.asarray(ref[0]))
    np.testing.assert_array_equal(np.asarray(restored.iters),
                                  np.asarray(ref[1]))
    stats = dst.lane_stats(restored)
    want = rprog.last_run_stats
    for key in ("push_supersteps", "pull_supersteps", "direction_switches",
                "edges_traversed", "partitions_swept", "partitions_skipped",
                "terminated"):
        assert stats[key] == want[key], key


def test_streamed_lane_restore_missing_field_typed(container):
    prog = translate(dsl.bfs_program(), D.load_partition_container(container),
                     ScheduleConfig(), device=CPU)
    snap = prog.lane_snapshot(prog.batch_init([0]))
    snap.pop("pull_cost")
    with pytest.raises(errors.CheckpointCorruptError) as ei:
        prog.lane_restore(snap)
    assert ei.value.member == "pull_cost"


def test_streamed_resume_against_wrong_graph(graphs, tmp_path):
    rng = np.random.default_rng(9)
    src, dst = RG.rmat_edges(800, 6400, seed=6)
    other = G.from_edge_list(src, dst, num_vertices=800,
                             weights=rng.uniform(0.5, 3.0, len(src)))
    a = D.load_partition_container(D.container_from_graph(
        str(tmp_path / "a.npz"), graphs[1], 3))
    b = D.load_partition_container(D.container_from_graph(
        str(tmp_path / "b.npz"), other, 3))
    translate(dsl.bfs_program(), a, ScheduleConfig(), CommManager(),
              device=CPU).run(roots=0, checkpoint_dir=str(tmp_path / "ck"),
                              checkpoint_every=1)
    prog = translate(dsl.bfs_program(), b, ScheduleConfig(), CommManager(),
                     device=CPU)
    with pytest.raises(errors.CheckpointMismatchError) as ei:
        prog.run(roots=0, checkpoint_dir=str(tmp_path / "ck"),
                 checkpoint_every=1, resume=True)
    assert ei.value.field == "graph"
