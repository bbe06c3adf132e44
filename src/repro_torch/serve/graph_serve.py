"""Graph-query serving plane: continuous-batched multi-source traversal.

Counterpart of ``repro.serve.graph_serve``.  A request queue accepts
``(program, root, kind)`` queries (bfs / sssp / ppr / dist), coalesces
compatible requests into fixed-slot batches, and runs them with per-lane
freeze/continuation so converged lanes free their slots for waiting
queries without restarting slow lanes — continuous batching, the graph
analogue of the decode slot pool in :mod:`repro_torch.serve.decode`.  The
lanes run on the run's device (CUDA unless the caller passes
``device="cpu"``); a batched superstep makes one device→host read for
all of its lanes, and a harvest copies only the finished lanes' tables
to the host.  Under ``ScheduleConfig(pes=p)`` the programs run on a PE
group (``devices=``, passed to ``translate``): a dense plan's push lanes
run sharded, and every answer still equals a sequential run's.

Structure::

    submit ──► queue ──► _BatchGroup (one per compiled program)
                           │  lane_admit into idle lanes
                           │  run_batch_slice(budget)      ← AdmissionPolicy
                           │  lane_done → harvest → free slot
                           ▼
                         done (answers bit-exact vs sequential run())

Correctness is *by construction*, not by re-derivation: a lane's
:class:`~repro_torch.core.translator.BatchLaneState` carries the complete
loop state (including the direction register and the measured pull-cost
register), so slicing partitions the exact superstep sequence a
sequential ``run(roots=root)`` would execute.  The parity tests
(``tests/test_torch_graph_serve.py``) pin every served answer against
that oracle and against the JAX package's server.

Point-to-point distance queries (``kind='dist'``) are answered from a
precomputed :class:`LandmarkTable` — SSSP from k landmark roots gives
triangle-inequality bounds; when lower == upper the answer is served
without touching the engine, otherwise an exact SSSP falls back through
the same batch plane.

Compiled programs are cached per program object (memoized DSL templates
return the *same* ``VertexProgram`` per parameter tuple), so a server
translates one logical query shape once.  Over a partitioned schedule
(``ScheduleConfig(partitions=P)`` or a byte budget) ``translate`` returns
the streamed engine's :class:`~repro_torch.core.stream.
PartitionedGraphProgram`, and the groups serve through its lane API
(:class:`~repro_torch.core.stream.PartitionedLaneState`), as the JAX
package's server does: the partitions stream once a batched superstep
for all lanes.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import numpy as np

from ..core import checkpoint as ckpt
from ..core import dsl
from ..core import faults
from ..core import graph as G
from ..core import tracing
from ..core.comm import CommManager, resolve_device
from ..core.scheduler import AdmissionPolicy, ScheduleConfig
from ..core.stream import PartitionedGraphProgram
from ..core.translator import CompiledGraphProgram, translate
from ..errors import (CheckpointError, CheckpointMismatchError, InvalidQuery,
                      QueueFull)

__all__ = ["GraphQuery", "GraphServer", "LandmarkTable",
           "build_landmark_table"]


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GraphQuery:
    """One serving-plane request and, once served, its answer.

    ``kind`` picks the template: ``'bfs'`` / ``'sssp'`` return the full
    (V,) level/distance vector from ``root``; ``'ppr'`` the personalized
    PageRank vector (fixed-iteration truncation, per-root program);
    ``'dist'`` the scalar ``d(root → target)``.  ``result`` is a host
    numpy array (or float for ``'dist'``); ``served_by`` records the path
    that produced it: ``'batch'`` (ran in a lane), ``'coalesced'`` (shared
    an identical in-flight query's lane), ``'landmark'`` (bounds pinned),
    ``'exact'`` (landmark fallback through the batch plane),
    ``'deadline'`` (degraded or truncated by deadline expiry).

    ``submitted_s``, ``admitted_s`` (when a lane took the query; None if
    none did) and ``finished_s`` are ``time.perf_counter()`` instants.
    ``deadline_s`` is an *absolute* ``time.perf_counter()`` instant
    (``submit(deadline_s=...)`` takes relative seconds and converts);
    past it the server stops spending supersteps on the query and
    degrades gracefully — see :meth:`GraphServer.step`.
    ``answer_quality`` records what the result means: ``'exact'`` (bit
    equal to the sequential oracle), ``'bounded'`` (dist query answered
    with its landmark upper bound, ``bounds`` holds (lower, upper)),
    ``'partial'`` (mid-run values harvested from an expired lane — a
    valid upper bound for min-reduce programs), ``'none'`` (expired
    before any compute; ``result`` is None).
    """

    qid: int
    kind: str
    root: int
    target: int | None = None
    program: Any = None
    status: str = "queued"      # 'queued' | 'running' | 'done' | 'cancelled'
    result: Any = None
    iters: int | None = None
    stats: dict | None = None
    served_by: str | None = None
    submitted_s: float = 0.0
    admitted_s: float | None = None
    finished_s: float = 0.0
    deadline_s: float | None = None
    answer_quality: str = "exact"
    bounds: tuple | None = None
    followers: list = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.status == "done"

    def cancel(self) -> bool:
        """Withdraw the query; False if it already completed.

        Cancellation is observed at the server's next :meth:`~GraphServer.
        step`: a queued/waiting query is dropped, a running lane is freed
        (promoting a coalesced follower to lane leader if one is live),
        and a parked dist query releases its inner SSSP.
        """
        if self.status == "done":
            return False
        self.status = "cancelled"
        return True

    def expired(self, now: float) -> bool:
        """True when a live query is past its deadline."""
        return (self.deadline_s is not None
                and self.status in ("queued", "running")
                and now > self.deadline_s)


# ---------------------------------------------------------------------------
# Landmark distance table (dist queries)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LandmarkTable:
    """Triangle-inequality distance bounds from k landmark SSSP sweeps.

    For landmarks L (directed graph, non-negative weights) the table holds
    ``d_out[L, v] = d(L → v)`` (SSSP on g) and ``d_in[L, v] = d(v → L)``
    (SSSP on the transposed graph).  For a query ``s → t``:

    * upper bound: ``min_L d_in[L, s] + d_out[L, t]`` — the best two-leg
      path s → L → t (∞ + anything stays ∞);
    * lower bound, from ``d(L,t) ≤ d(L,s) + d(s,t)`` and
      ``d(s,L) ≤ d(s,t) + d(t,L)``:
      ``max_L max(d_out[L,t] − d_out[L,s], d_in[L,s] − d_in[L,t], 0)``
      over finite pairs — and when ``d_out[L,s]`` is finite but
      ``d_out[L,t]`` is ∞ (or ``d_in[L,t]`` finite but ``d_in[L,s]`` ∞),
      t is unreachable from s outright: L reaches s (resp. t reaches L),
      so a finite s→t path would make the ∞ entry finite too.

    The bounds *pin* the answer when lower == upper (including ∞ == ∞,
    i.e. proven-unreachable) or s == t; otherwise the server falls back to
    an exact SSSP through the batch plane.
    """

    landmarks: np.ndarray          # (k,) int32 vertex ids
    d_out: np.ndarray              # (k, V) float32, d(L -> v)
    d_in: np.ndarray               # (k, V) float32, d(v -> L)

    def bounds(self, s: int, t: int) -> tuple[float, float]:
        """(lower, upper) on ``d(s → t)``; equal means pinned."""
        if s == t:
            return 0.0, 0.0
        ls, lt = self.d_in[:, s], self.d_out[:, t]          # s→L, L→t
        upper = float(np.min(ls + lt)) if ls.size else np.inf

        os_, ot = self.d_out[:, s], self.d_out[:, t]        # L→s, L→t
        ts, tt = self.d_in[:, s], self.d_in[:, t]           # s→L, t→L
        # unreachability certificates (see class docstring)
        if np.any(np.isfinite(os_) & np.isinf(ot)) \
                or np.any(np.isinf(ts) & np.isfinite(tt)):
            return np.inf, np.inf if np.isinf(upper) else upper
        lower = 0.0
        fin = np.isfinite(os_) & np.isfinite(ot)
        if np.any(fin):
            lower = max(lower, float(np.max(ot[fin] - os_[fin])))
        fin = np.isfinite(ts) & np.isfinite(tt)
        if np.any(fin):
            lower = max(lower, float(np.max(ts[fin] - tt[fin])))
        return lower, upper

    def pinned(self, s: int, t: int) -> bool:
        lo, up = self.bounds(s, t)
        return lo == up or (np.isinf(lo) and np.isinf(up))


def choose_landmarks(g: G.Graph, k: int) -> np.ndarray:
    """Deterministic landmark pick: top-k by total degree, ties by id.

    High-degree vertices sit on many shortest paths, so their SSSP sweeps
    pin the most queries; the sort is stable on vertex id, so rebuilds of
    the same graph choose the same landmarks.
    """
    out_deg = g.out_degrees.cpu().numpy().astype(np.int64)
    in_deg = np.bincount(g.edges_dst.cpu().numpy(),
                         minlength=g.num_vertices)[:g.num_vertices]
    total = out_deg + in_deg
    order = np.lexsort((np.arange(g.num_vertices), -total))
    return order[:min(k, g.num_vertices)].astype(np.int32)


def build_landmark_table(g: G.Graph, k: int, *,
                         schedule: ScheduleConfig | None = None,
                         device=None, devices=None) -> LandmarkTable:
    """SSSP from k landmarks on g and its transpose, batched per sweep.

    Both sweeps run through the same translate/run_batch plane the server
    uses, so table entries are bit-identical to served SSSP answers —
    the bound-sanity tests rely on that.  Deterministic: landmark choice
    is degree-ranked (stable) and the engine is bit-exact across modes.
    """
    lm = choose_landmarks(g, k)
    prog = dsl.sssp_program()
    fwd = translate(prog, g, schedule, device=device, devices=devices)
    d_out, _ = fwd.run_batch(lm)
    bwd = translate(prog, G.reverse(g), schedule, device=device,
                    devices=devices)
    d_in, _ = bwd.run_batch(lm)
    return LandmarkTable(landmarks=lm,
                         d_out=d_out.cpu().numpy().astype(np.float32),
                         d_in=d_in.cpu().numpy().astype(np.float32))


# ---------------------------------------------------------------------------
# Batch groups: one fixed slot pool per compiled program
# ---------------------------------------------------------------------------


class _BatchGroup:
    """A fixed ``slots``-lane batch over one compiled program.

    Mirrors :class:`repro_torch.serve.decode.BatchScheduler`'s slot pool:
    ``occupants[lane]`` is the query running in that lane (None = idle),
    ``waiting`` holds admitted-but-unslotted queries.  The lane state is
    the translator's :class:`BatchLaneState` (a streamed program's
    :class:`~repro_torch.core.stream.PartitionedLaneState`, with the same
    lane API and counters); admission writes one lane
    (`lane_admit`), slices advance every live lane, harvest frees lanes
    whose query converged.
    """

    def __init__(self, compiled: CompiledGraphProgram
                 | PartitionedGraphProgram, slots: int):
        self.compiled = compiled
        self.slots = slots
        self.state = compiled.batch_idle(slots)
        self.occupants: list[GraphQuery | None] = [None] * slots
        self.waiting: collections.deque[GraphQuery] = collections.deque()
        self.supersteps = 0            # sliced supersteps executed (max lane)
        # batched supersteps run, the lanes they stepped, those that ran
        # the batched masked sweep and those that ran the batched push,
        # and reads of finished lanes' tables
        self.batched_supersteps = 0
        self.lane_steps = 0
        self.masked_sweeps = 0
        self.lane_pushes = 0
        self.harvests = 0
        # queries a lane took, and their summed seconds from submission
        # to admission
        self.admitted = 0
        self.queue_wait_s = 0.0
        self._reads0 = compiled.lane_reads

    @property
    def host_reads(self) -> int:
        """Device→host reads this group's program made since the group
        was created (occupancy reads and harvest copies)."""
        return self.compiled.lane_reads - self._reads0

    @property
    def idle(self) -> bool:
        return not self.waiting and all(q is None for q in self.occupants)

    def admit(self) -> int:
        """Fill idle lanes from the waiting queue; returns admits done."""
        n = 0
        for lane, occ in enumerate(self.occupants):
            if occ is None and self.waiting:
                q = self.waiting.popleft()
                self.state = self.compiled.lane_admit(self.state, lane,
                                                      q.root)
                self.occupants[lane] = q
                q.status = "running"
                q.admitted_s = time.perf_counter()
                self.queue_wait_s += q.admitted_s - q.submitted_s
                n += 1
        self.admitted += n
        return n

    def slice(self, budget: int) -> None:
        """Advance live lanes by ≤ budget supersteps (no-op when idle)."""
        if all(q is None for q in self.occupants):
            return
        c = self.compiled
        before = int(np.max(self.state.iters))
        steps, stepped, sweeps, pushes = c.lane_supersteps, c.lane_steps, \
            c.lane_sweeps, c.lane_pushes
        self.state = c.run_batch_slice(self.state, budget)
        self.supersteps += int(np.max(self.state.iters)) - before
        self.batched_supersteps += c.lane_supersteps - steps
        self.lane_steps += c.lane_steps - stepped
        self.masked_sweeps += c.lane_sweeps - sweeps
        self.lane_pushes += c.lane_pushes - pushes

    def harvest(self, now: float) -> list[GraphQuery]:
        """Complete queries in converged lanes; free their slots."""
        done_lanes = self.compiled.lane_done(self.state)
        finished: list[GraphQuery] = []
        lanes = [i for i, q in enumerate(self.occupants)
                 if q is not None and done_lanes[i]]
        if not lanes:
            return finished
        stats = self.compiled.lane_stats(self.state)
        # only the finished lanes' tables come to the host, in one read
        values = dict(zip(lanes, self.compiled.lane_values(self.state,
                                                           lanes)))
        self.harvests += 1
        iters = self.state.iters
        for lane in lanes:
            q = self.occupants[lane]
            q.result = values[lane]
            q.iters = int(iters[lane])
            q.stats = {k: (v[lane] if isinstance(v, list) else v)
                       for k, v in stats.items() if k != "batch_size"}
            q.status = "done"
            q.served_by = q.served_by or "batch"
            q.finished_s = now
            for f in q.followers:
                if f.status == "cancelled":
                    f.finished_s = now
                    finished.append(f)
                    continue
                f.result = q.result
                f.iters = q.iters
                f.stats = q.stats
                f.status = "done"
                f.served_by = "coalesced"
                f.finished_s = now
                finished.append(f)
            q.followers = []
            self.occupants[lane] = None
            finished.append(q)
        return finished

    def reap(self, now: float) -> list[tuple[GraphQuery, GraphQuery | None]]:
        """Retire cancelled/deadline-expired queries; free their lanes.

        Returns ``(query, promoted)`` pairs — ``promoted`` is the
        coalesced follower that inherited a cancelled leader's lane (the
        server re-points its in-flight table at it), else None.  A lane
        whose *deadline* expired finalizes leader and followers together
        with the mid-run values (``answer_quality='partial'``); a
        *cancelled* leader's computation survives if any follower is
        still live.  Waiting (never-admitted) queries drop with
        ``answer_quality='none'``.
        """
        finished: list[tuple[GraphQuery, GraphQuery | None]] = []
        freed: list[int] = []
        stats = iters = None
        for lane, q in enumerate(self.occupants):
            if q is None or not (q.status == "cancelled" or q.expired(now)):
                continue
            if q.status == "cancelled":
                live = [f for f in q.followers if f.status != "cancelled"]
                dead = [f for f in q.followers if f.status == "cancelled"]
                q.finished_s = now
                for f in dead:
                    f.finished_s = now
                    finished.append((f, None))
                if live:
                    leader = live[0]
                    leader.followers = live[1:]
                    q.followers = []
                    self.occupants[lane] = leader
                    finished.append((q, leader))
                    continue            # lane keeps running under leader
                q.followers = []
                finished.append((q, None))
            else:                       # deadline expiry: shared fate
                if stats is None:
                    stats = self.compiled.lane_stats(self.state)
                    iters = self.state.iters
                q.result = self.compiled.lane_values(self.state, [lane])[0]
                self.harvests += 1
                q.iters = int(iters[lane])
                q.stats = {k: (v[lane] if isinstance(v, list) else v)
                           for k, v in stats.items() if k != "batch_size"}
                q.answer_quality = "partial"
                q.served_by = "deadline"
                q.status = "done"
                q.finished_s = now
                for f in q.followers:
                    if f.status != "cancelled":
                        f.result = q.result
                        f.iters = q.iters
                        f.stats = q.stats
                        f.answer_quality = "partial"
                        f.served_by = "coalesced"
                        f.status = "done"
                    f.finished_s = now
                    finished.append((f, None))
                q.followers = []
                finished.append((q, None))
            freed.append(lane)
            self.occupants[lane] = None
        if freed:
            active = self.state.active.clone()
            for lane in freed:
                active[lane] = False
            self.state = self.state._replace(active=active)
        if self.waiting:
            keep: collections.deque[GraphQuery] = collections.deque()
            for q in self.waiting:
                if q.status == "cancelled" or q.expired(now):
                    if q.status != "cancelled":
                        q.answer_quality = "none"
                        q.served_by = "deadline"
                        q.status = "done"
                    q.finished_s = now
                    live = [f for f in q.followers
                            if f.status != "cancelled"]
                    for f in q.followers:
                        if f not in live:
                            f.finished_s = now
                            finished.append((f, None))
                    q.followers = []
                    if live:        # followers take over the queue slot
                        leader = live[0]
                        leader.followers = live[1:]
                        keep.append(leader)
                        finished.append((q, leader))
                    else:
                        finished.append((q, None))
                else:
                    keep.append(q)
            self.waiting = keep
        return finished


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------


class GraphServer:
    """Continuous-batched graph-query server over one graph.

    >>> server = GraphServer(g, landmarks=4)
    >>> q1 = server.submit("bfs", root=0)
    >>> q2 = server.submit("dist", root=3, target=17)
    >>> server.run()
    >>> q1.result        # (V,) levels, bit-exact vs translate(...).run()
    >>> q2.result        # float distance (landmark-pinned or exact)

    One :class:`_BatchGroup` (fixed slot pool, ``AdmissionPolicy.slots``
    lanes) exists per compiled program; per-root programs like ppr get
    single-lane groups, since their lanes can't be root-batched.  ``step``
    is the serving loop body: route queue → admit → slice → harvest;
    ``run`` drains everything.  All compiled programs are held on the
    server, keyed by program identity, so repeat queries never
    re-translate.
    """

    KINDS = ("bfs", "sssp", "ppr", "dist")

    def __init__(self, g: G.Graph, *,
                 schedule: ScheduleConfig | None = None,
                 admission: AdmissionPolicy | None = None,
                 landmarks: int = 0,
                 comm: CommManager | None = None,
                 device=None, devices=None,
                 ppr_damping: float = 0.85, ppr_iters: int = 20):
        self.graph = g
        self.schedule = schedule or ScheduleConfig()
        self.admission = admission or AdmissionPolicy()
        self._comm = comm
        self.device = resolve_device(device)
        self.devices = devices
        self._ppr_damping = ppr_damping
        self._ppr_iters = ppr_iters
        self._programs: dict[Any, CompiledGraphProgram] = {}
        self._groups: dict[Any, _BatchGroup] = {}
        self._queue: collections.deque[GraphQuery] = collections.deque()
        self._inflight: dict[tuple, GraphQuery] = {}
        self._parked: list[tuple[GraphQuery, GraphQuery]] = []
        self.done: list[GraphQuery] = []
        self._next_qid = 0
        self._snap_seq = 0
        self.table: LandmarkTable | None = (
            build_landmark_table(g, landmarks, schedule=self.schedule,
                                 device=self.device, devices=devices)
            if landmarks > 0 else None)

    # -- submission --------------------------------------------------------

    def _program_for(self, kind: str, root: int):
        if kind == "bfs":
            return dsl.bfs_program()
        if kind in ("sssp", "dist"):
            return dsl.sssp_program()
        if kind == "ppr":
            return dsl.ppr_program(root, damping=self._ppr_damping,
                                   iters=self._ppr_iters)
        raise InvalidQuery(f"unsupported query kind: {kind!r} "
                           f"(one of {self.KINDS})")

    def submit(self, kind: str, root: int, *, target: int | None = None,
               program=None, deadline_s: float | None = None) -> GraphQuery:
        """Enqueue a query; returns the (not yet answered) handle.

        ``kind='dist'`` requires ``target`` and may complete immediately
        when the landmark bounds pin the answer.  ``program`` overrides
        the template (custom :class:`VertexProgram`); it must be rooted
        the way bfs/sssp are (``init_state(roots=root)`` semantics).
        ``deadline_s`` is a *relative* budget in seconds; past it the
        server degrades the answer instead of finishing the run (see
        :meth:`step`).  Malformed queries raise
        :class:`repro_torch.errors.InvalidQuery`; back-pressure raises
        :class:`repro_torch.errors.QueueFull` (both keep their legacy
        ``ValueError``/``RuntimeError`` bases).
        """
        V = self.graph.num_vertices
        if not 0 <= int(root) < V:
            raise InvalidQuery(f"root {root} out of range [0, {V})")
        if kind == "dist":
            if target is None:
                raise InvalidQuery("dist queries need target=")
            if not 0 <= int(target) < V:
                raise InvalidQuery(f"target {target} out of range [0, {V})")
        elif target is not None:
            raise InvalidQuery(
                f"target= is only for dist queries, not {kind}")
        if self.admission.max_queue and \
                self.pending >= self.admission.max_queue:
            raise QueueFull(
                f"queue full ({self.admission.max_queue}); drain with "
                "step()/run() before submitting more",
                pending=self.pending, max_queue=self.admission.max_queue)
        now = time.perf_counter()
        q = GraphQuery(qid=self._next_qid, kind=kind, root=int(root),
                       target=None if target is None else int(target),
                       program=program or self._program_for(kind, int(root)),
                       submitted_s=now,
                       deadline_s=None if deadline_s is None
                       else now + float(deadline_s))
        self._next_qid += 1
        if kind == "dist" and self.table is not None:
            lo, up = self.table.bounds(q.root, q.target)
            if lo == up or (np.isinf(lo) and np.isinf(up)):
                q.result = float(up)
                q.status = "done"
                q.served_by = "landmark"
                q.finished_s = time.perf_counter()
                self.done.append(q)
                return q
        self._queue.append(q)
        return q

    # -- serving loop ------------------------------------------------------

    @property
    def pending(self) -> int:
        """Queries accepted but not yet answered."""
        n = len(self._queue) + len(self._parked)
        for grp in self._groups.values():
            n += len(grp.waiting)
            n += sum(q is not None for q in grp.occupants)
        n += sum(len(q.followers) for key, q in self._inflight.items())
        return n

    def _group_for(self, program) -> _BatchGroup:
        grp = self._groups.get(program)
        if grp is None:
            compiled = self._programs.get(program)
            if compiled is None:
                compiled = translate(program, self.graph, self.schedule,
                                     self._comm, device=self.device,
                                     devices=self.devices)
                self._programs[program] = compiled
            # per-root programs (ppr) can't share lanes across roots —
            # their group is single-lane and distinct per root, relying on
            # coalescing to fold duplicates into one lane
            slots = 1 if getattr(program, "name", "") == "ppr" \
                else self.admission.slots
            grp = _BatchGroup(compiled, slots)
            self._groups[program] = grp
        return grp

    def _route(self) -> None:
        """Drain the front queue into per-program groups (+ coalescing).

        Cancelled queries retire here; queries already past their
        deadline never reach a lane — dist degrades to its landmark
        bounds, others finalize empty (``answer_quality='none'``).
        """
        now = time.perf_counter()
        while self._queue:
            q = self._queue.popleft()
            if q.status == "cancelled":
                q.finished_s = now
                self.done.append(q)
                continue
            if q.expired(now):
                self._degrade(q, now)
                continue
            if q.kind == "dist":
                # exact fallback: ride a full sssp from root through the
                # batch plane (coalescing with any in-flight sssp from the
                # same root), then read off values[target] when it lands
                inner = GraphQuery(qid=-q.qid - 1, kind="sssp",
                                   root=q.root, program=q.program,
                                   submitted_s=q.submitted_s,
                                   deadline_s=q.deadline_s)
                self._parked.append((q, inner))
                q.status = "running"
                self._enqueue(inner)
            else:
                self._enqueue(q)

    def _degrade(self, q: GraphQuery, now: float,
                 inner: GraphQuery | None = None) -> None:
        """Deadline fallback: best available answer without more compute.

        ``dist`` queries fall back to their landmark (lower, upper)
        bounds — tightened by the inner SSSP's partial distances when the
        lane ran at all (mid-run min-reduce values are valid upper
        bounds) — and report ``answer_quality='bounded'``.  Other kinds
        have no cheap bound, so they finalize with ``result=None`` and
        ``answer_quality='none'``.
        """
        if q.kind == "dist":
            lo, up = (self.table.bounds(q.root, q.target)
                      if self.table is not None else (0.0, float("inf")))
            if inner is not None and inner.result is not None:
                up = min(up, float(np.asarray(inner.result)[q.target]))
            q.result = float(up)
            # float32 table noise can push lower an ulp past upper when a
            # landmark sits on the shortest path — report a sane interval
            q.bounds = (min(float(lo), float(up)), float(up))
            q.answer_quality = "bounded"
        else:
            q.answer_quality = "none"
        q.served_by = "deadline"
        q.status = "done"
        q.finished_s = now
        self.done.append(q)

    def _enqueue(self, q: GraphQuery) -> None:
        """Coalesce onto an identical in-flight query or take a lane."""
        key = (q.program, q.root)
        if self.admission.coalesce:
            leader = self._inflight.get(key)
            if leader is not None and not leader.done:
                leader.followers.append(q)
                q.status = "running"
                return
            self._inflight[key] = q
        self._group_for(q.program).waiting.append(q)

    def _resolve_parked(self, now: float) -> None:
        still: list[tuple[GraphQuery, GraphQuery]] = []
        for q, inner in self._parked:
            if q.status == "cancelled":
                inner.cancel()
                q.finished_s = now
                self.done.append(q)
            elif inner.done and inner.answer_quality == "exact":
                q.result = float(inner.result[q.target])
                q.iters = inner.iters
                q.stats = inner.stats
                q.status = "done"
                q.served_by = "exact"
                q.finished_s = now
                self.done.append(q)
            elif (q.expired(now) or inner.status == "cancelled"
                  or inner.done):
                # deadline hit (or the inner run was truncated by one):
                # stop the inner sweep and serve landmark bounds instead
                inner.cancel()
                self._degrade(q, now, inner=inner)
            else:
                still.append((q, inner))
        self._parked = still

    def _retire(self, q: GraphQuery,
                promoted: GraphQuery | None = None) -> None:
        """Drop a finished/cancelled query from the in-flight table."""
        key = (q.program, q.root)
        if self._inflight.get(key) is q:
            if promoted is not None:
                self._inflight[key] = promoted
            else:
                del self._inflight[key]
        if q.qid >= 0:
            self.done.append(q)

    # -- durable snapshot / rolling restart --------------------------------

    def _wal_record(self, q: GraphQuery, loc: str, now: float,
                    **extra) -> dict:
        """One request-WAL entry: everything needed to re-create ``q``.

        Programs are *not* serialized — the record carries (kind, root)
        and restore re-derives the memoized template, which is why a
        query carrying a custom ``program=`` override refuses to
        snapshot (there is no durable identity to rebuild it from).
        """
        if q.program is not self._program_for(q.kind, q.root):
            raise CheckpointError(
                f"query {q.qid} ({q.kind!r}) carries a custom program "
                "override; snapshot() can only re-derive template "
                "programs from (kind, root)")
        rec = {"qid": q.qid, "kind": q.kind, "root": q.root,
               "target": q.target, "loc": loc, "status": q.status,
               "deadline_remaining_s":
               None if q.deadline_s is None else q.deadline_s - now,
               "inflight":
               self._inflight.get((q.program, q.root)) is q}
        rec.update(extra)
        return rec

    def snapshot(self, directory: str) -> str:
        """Commit the serving plane's full pending state durably.

        Two halves, one atomic snapshot (kind ``'serve'``):

        * a **request WAL** — one record per unanswered query (queued,
          waiting, running in a lane, coalesced follower, parked dist),
          with its queue/lane position, coalescing links (follower →
          leader qid; parked outer ↔ inner by the ``-qid-1`` rule) and
          remaining deadline budget;
        * the **harvested lane states** — each non-idle group's full
          :class:`BatchLaneState` via ``lane_snapshot``, keyed
          ``g{gid}__{field}``, so restored lanes resume mid-run rather
          than recompute from their roots.

        Fingerprinted against the graph and schedule; answered queries
        (``done``) are the caller's to keep — a snapshot only covers
        work still owed.  Returns the snapshot stem.
        """
        now = time.perf_counter()
        records: list[dict] = []
        groups: list[dict] = []

        def emit(q, loc, **extra):
            records.append(self._wal_record(q, loc, now, **extra))
            for f in q.followers:
                records.append(
                    self._wal_record(f, "follower", now, leader=q.qid))

        for q in self._queue:
            emit(q, "queue")
        arrays: dict[str, np.ndarray] = {}
        for gid, grp in enumerate(self._groups.values()):
            if grp.idle:
                continue
            rep = next(q for q in list(grp.occupants) + list(grp.waiting)
                       if q is not None)
            groups.append({
                "gid": gid, "kind": rep.kind, "root": rep.root,
                "slots": grp.slots, "supersteps": grp.supersteps,
                "occupants": [None if q is None else q.qid
                              for q in grp.occupants]})
            for lane, q in enumerate(grp.occupants):
                if q is not None:
                    emit(q, "lane", gid=gid, lane=lane)
            for pos, q in enumerate(grp.waiting):
                emit(q, "waiting", gid=gid, pos=pos)
            for name, arr in grp.compiled.lane_snapshot(grp.state).items():
                arrays[f"g{gid}__{name}"] = arr
        for q, _inner in self._parked:
            emit(q, "parked")
        meta = {"records": records, "groups": groups,
                "next_qid": self._next_qid,
                "ppr_damping": self._ppr_damping,
                "ppr_iters": self._ppr_iters,
                "slots": self.admission.slots,
                "coalesce": bool(self.admission.coalesce)}
        fps = {"graph": ckpt.fingerprint_graph(self.graph),
               "schedule": ckpt.fingerprint_schedule(self.schedule)}
        stem = ckpt.write_snapshot(directory, "serve", self._snap_seq,
                                   arrays, meta, fps)
        self._snap_seq += 1
        return stem

    def restore(self, directory: str) -> int:
        """Rolling restart: load the newest ``'serve'`` snapshot.

        Call on a *freshly constructed* server with the same graph,
        schedule, and admission config (mismatches raise
        :class:`~repro_torch.errors.CheckpointMismatchError`; a non-empty
        server raises :class:`~repro_torch.errors.CheckpointError`).  Every
        pending query is re-created under its original qid with its
        coalescing links and remaining deadline budget, and every lane
        resumes from its harvested mid-run state — so a drain after
        restore serves each query bit-equal to the uninterrupted server.
        Returns the number of queries restored.
        """
        if (self._queue or self._groups or self._parked or self.done
                or self._inflight or self._next_qid):
            raise CheckpointError(
                "restore() needs a freshly constructed server (this one "
                "already holds queries or served answers)")
        stem = ckpt.require_snapshot(directory, "serve")
        expect = {"graph": ckpt.fingerprint_graph(self.graph),
                  "schedule": ckpt.fingerprint_schedule(self.schedule)}
        manifest, arrays = ckpt.read_snapshot(stem, kind="serve",
                                              expect=expect)
        meta = manifest["meta"]
        if (meta["ppr_damping"] != self._ppr_damping
                or meta["ppr_iters"] != self._ppr_iters):
            raise CheckpointMismatchError(
                "snapshot served ppr with damping="
                f"{meta['ppr_damping']}/iters={meta['ppr_iters']}, this "
                f"server uses {self._ppr_damping}/{self._ppr_iters}",
                field="program",
                expected=f"{self._ppr_damping}/{self._ppr_iters}",
                got=f"{meta['ppr_damping']}/{meta['ppr_iters']}")
        if meta["slots"] != self.admission.slots:
            raise CheckpointMismatchError(
                f"snapshot lane pools have {meta['slots']} slots, this "
                f"server admits {self.admission.slots}",
                field="admission", expected=str(self.admission.slots),
                got=str(meta["slots"]))
        now = time.perf_counter()
        qs: dict[int, GraphQuery] = {}
        for rec in meta["records"]:
            rem = rec["deadline_remaining_s"]
            q = GraphQuery(
                qid=int(rec["qid"]), kind=rec["kind"],
                root=int(rec["root"]),
                target=None if rec["target"] is None else int(rec["target"]),
                program=self._program_for(rec["kind"], int(rec["root"])),
                status=rec["status"], submitted_s=now,
                deadline_s=None if rem is None else now + float(rem))
            qs[q.qid] = q
        # placement pass: links first (followers/inflight), then queues,
        # lanes, and waiting lists in their recorded order
        for rec in meta["records"]:
            q = qs[rec["qid"]]
            if rec["loc"] == "follower":
                qs[rec["leader"]].followers.append(q)
            if rec["inflight"]:
                self._inflight[(q.program, q.root)] = q
        for rec in meta["records"]:
            if rec["loc"] == "queue":
                self._queue.append(qs[rec["qid"]])
        for grec in meta["groups"]:
            program = self._program_for(grec["kind"], int(grec["root"]))
            grp = self._group_for(program)
            if grp.slots != grec["slots"]:
                raise CheckpointMismatchError(
                    f"group for {grec['kind']!r} has {grp.slots} lanes, "
                    f"snapshot recorded {grec['slots']}",
                    field="admission", expected=str(grp.slots),
                    got=str(grec["slots"]))
            prefix = f"g{grec['gid']}__"
            grp.state = grp.compiled.lane_restore(
                {k[len(prefix):]: v for k, v in arrays.items()
                 if k.startswith(prefix)})
            grp.supersteps = int(grec["supersteps"])
            for lane, qid in enumerate(grec["occupants"]):
                if qid is not None:
                    grp.occupants[lane] = qs[qid]
            waiting = sorted(
                (rec for rec in meta["records"]
                 if rec["loc"] == "waiting" and rec["gid"] == grec["gid"]),
                key=lambda rec: rec["pos"])
            for rec in waiting:
                grp.waiting.append(qs[rec["qid"]])
        for rec in meta["records"]:
            if rec["loc"] == "parked":
                q = qs[rec["qid"]]
                self._parked.append((q, qs[-q.qid - 1]))
        self._next_qid = int(meta["next_qid"])
        return len(qs)

    def step(self) -> bool:
        """One serving iteration: route → reap → admit → slice → harvest.

        Returns True while the server still holds unanswered queries.
        The reap pass enforces deadlines and cancellation: expired lanes
        finalize with their mid-run values (``answer_quality='partial'``)
        and free their slots, cancelled lanes hand off to a live
        coalesced follower or free outright, and parked dist queries past
        deadline degrade to landmark bounds (``answer_quality='bounded'``)
        — a deadline never hangs a slot or silently drops a query.

        Each group's admit and harvest are the spans ``serve.admit`` and
        ``serve.harvest`` (:mod:`~repro_torch.core.tracing`); its slice
        is the lane loop's ``lane.step`` and ``lane.read`` spans.
        """
        self._route()
        # crash point between routing and slicing: a killed server is
        # restartable from snapshot() with no query half-sliced
        faults.trip("lane.crash", payload={"pending": self.pending})
        budget = self.admission.slice_supersteps
        progressed = False
        for program, grp in list(self._groups.items()):
            now = time.perf_counter()
            reaped = grp.reap(now)
            for q, promoted in reaped:
                self._retire(q, promoted)
            progressed = progressed or bool(reaped)
            if grp.idle:
                continue
            progressed = True
            with tracing.span("serve.admit"):
                grp.admit()
            grp.slice(budget)
            now = time.perf_counter()
            with tracing.span("serve.harvest"):
                finished = grp.harvest(now)
            for q in finished:
                self._retire(q)
        self._resolve_parked(time.perf_counter())
        return progressed or bool(self._queue) or bool(self._parked)

    def counters(self) -> dict:
        """The serving plane's work so far, summed over its batch groups:
        batched supersteps, the lanes they stepped, those that ran the
        batched masked sweep and those that ran the batched push, queries
        admitted to a lane and their summed seconds from submission to
        admission, reads of finished lanes' tables, and all device→host
        reads."""
        groups = list(self._groups.values())
        return {k: sum(getattr(grp, k) for grp in groups)
                for k in ("batched_supersteps", "lane_steps",
                          "masked_sweeps", "lane_pushes", "admitted",
                          "queue_wait_s", "harvests", "host_reads")}

    def run(self) -> list[GraphQuery]:
        """Drain every pending query; returns them in completion order."""
        while self.pending:
            if not self.step():
                break
        return self.done
