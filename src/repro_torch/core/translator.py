"""Light-weight translator (paper §V): DSL program × schedule → executable.

Counterpart of ``repro.core.translator`` for a resident graph on one
device, under the pull, push and auto directions:

1. :func:`~repro_torch.core.ir.lower_program` lowers the program to IR;
2. :func:`~repro_torch.core.passes.default_pipeline` runs the eight
   passes;
3. :func:`translate` walks the optimized IR and emits the supersteps.
   The pull plane is the dense sweep over the flat width-8 view
   (:func:`_emit_dense_pull_reduce`), the block-skipping bitmap plane
   over the same view (:func:`_emit_pull_bitmap`), or the sparse
   backend's chunk-streamed scatter over the reverse COO
   (:func:`_emit_segment_scan_reduce`).  When push is legal and wanted
   its twin is the frontier-compacted forward-ELL superstep
   (:func:`_emit_push_ell`) or the chunk-streamed forward-COO scatter
   (:func:`_emit_push_scatter`).

The hand-written CUDA kernels are on exactly when the run's device is
CUDA (the JAX package turns Pallas on exactly on a TPU): the dense sweep
goes through ``kernels/edge_block.py``'s kernel, the bitmap plane through
its block-skipping variant, and the compacted push's messages and combine
through ``kernels/push_ell.py``'s fused kernel.  On the CPU all take their
plain PyTorch forms,
so the tests hold the port against the JAX package there.  The sparse
backend runs PyTorch scatters on either device, as the JAX package's runs
XLA scatters.

Algorithm 1's loop (:meth:`CompiledGraphProgram.run`) is a host loop: the
JAX package stages it as ``lax.while_loop`` with a ``lax.cond`` direction
switch and a ``lax.switch`` tier choice.  Here each superstep reads, in
one transfer, any-active, the frontier's out-edges ``m_f``, its vertex
count ``n_f``, its live forward-ELL rows ``r_f`` and the previous pull
superstep's sweep counters, and branches on the host: one device→host
sync per superstep.  The direction choice is computed in float32 exactly
as the staged loop computes it, and the counters are Python integers, so
``run_stats`` equal the JAX package's.

Batched runs (:meth:`CompiledGraphProgram.run_batch` and the lane API the
serving plane builds on: :class:`BatchLaneState`, ``batch_init``,
``lane_admit``, ``run_batch_slice``, ``lane_done``, ``lane_stats``,
``lane_snapshot``, ``lane_restore``) keep that host loop and add a lane
axis: ``(k, V)`` tables and frontiers on the device, each lane's
counters, direction and pull-cost registers on the host, and one
device→host read per batched superstep for all lanes.  Each lane decides
its own direction and tier as a sequential run would, so its values and
counters equal ``run(roots=r)``'s; frozen and idle lanes launch nothing.
Lanes are grouped by route, since every route computes the same
superstep: on the dense and bitmap planes, the lanes whose superstep is
the masked sweep (pull lanes, and push lanes past the largest tier) go
through one launch of the fused lane sweep
(``edge_block.edge_block_fold_lanes``; a float add, whose fold has an
order, takes ``edge_block.edge_block_reduce_lanes`` and
``subrow_combine``), and the push lanes within a tier through one launch
of the lane push (``push_ell.push_ell_lanes_reduce``, no compaction), both
reading and writing the lanes' rows in place.  On the bitmap plane the
sweep is 2L, the lane sweep with a per-lane early-out: the pull lanes in
a narrow tier take their touched tables in one pass
(``push_ell.push_lanes_touched``) and one flag a grid block each, the
other sweep lanes read every block, and each pull lane's block counters
stay on the device until the superstep's read.  The sparse plane steps
each lane through its single-lane superstep.  Checkpointed runs
(``run(checkpoint_dir=...)``) are one-lane slice loops that commit a
:mod:`~repro_torch.core.checkpoint` snapshot after every slice.

A plan over several PEs (``ScheduleConfig(pes=p)`` on a device list,
``translate(..., devices=[...])``) shards a plane as the JAX package's
mesh does, with one controller driving every PE: a dense plan shards its
push plane (:func:`_emit_push_ell`: each PE runs the compacted
push, kernel 3f, on its forward-ELL interval into a partial table on its
device, and the reduce-matched collective of :mod:`~repro_torch.core.
comm` combines them; a frontier too wide for the largest tier on any PE
takes the replicated dense sweep, kernel 1, with no exchange), a sparse
plan its pull plane (:func:`_emit_exchange`: each PE scatters its slice
of the chunks, then the collective, or ``quantized_psum`` for an int8
float add, and ``bitmap_or`` of the touched masks).  The batched push
lanes run the lane push (3L) a PE over that PE's interval.  Values,
``iters`` and ``run_stats`` equal the JAX package's at the same PE
count, and the run loop records the executed exchanges on the comm
manager (``comm.collective``).

A plan over several partitions, or a partition container in place of a
resident graph, goes to the streamed engine
(:func:`repro_torch.core.stream.translate_partitioned`), as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
import time
import typing

import numpy as np
import torch

from ..errors import (CheckpointCorruptError, CheckpointMismatchError,
                      DiagnosticError)
from ..kernels import edge_block as edge_block_kernel
from ..kernels import pull_bitmap as pull_bitmap_kernel
from ..kernels import push_ell as push_ell_kernel
from ..kernels import push_scatter as push_scatter_kernel
from ..kernels.ref import combine_settled, row_reduce_settled
from . import checkpoint as ckpt
from . import comm as C
from . import faults
from . import graph as G
from . import preprocess
from . import tracing
from .analysis import analyze_program, apply_batches_over_lanes
from .comm import CommManager, resolve_device
from .diagnostics import max_severity, render_table
from .dsl import VertexProgram
from .ir import (ApplyOp, ExchangeOp, FrontierUpdateOp, FusedGatherReduceOp,
                 FusedSuperstepOp, PushScatterOp, SuperstepIR, lower_program)
from .passes import PassContext, classify_gather, default_pipeline
from .scheduler import (DirectionPolicy, ScheduleConfig, SchedulePlan, plan,
                        pull_block_capacities, push_capacity_tiers)

__all__ = ["classify_gather", "TranslationReport", "CompiledGraphProgram",
           "BatchLaneState", "translate"]


class BatchLaneState(typing.NamedTuple):
    """Resumable per-lane state of a batched run, the JAX package's
    fields in its order and dtypes.

    ``values`` and ``active`` are ``(k, V)`` tensors on the run's device;
    the other thirteen fields are host numpy ``int32`` arrays with a
    leading lane axis (``pe_rows`` is ``(k, pes)``), since the host loop
    reads and decides per lane: iterations, the direction register, the
    push/compacted/switch counters, the push and pull edge counters split
    into 16-bit words (as the staged loop splits them, so snapshots cross
    packages), live forward-ELL rows, the swept/skipped block counters
    and the measured pull-cost register.  A lane resumed from any of
    these makes the same choices a sequential run would have made.

    Produced by :meth:`CompiledGraphProgram.batch_init`, advanced by
    :meth:`CompiledGraphProgram.run_batch_slice`, recycled lane by lane
    by :meth:`CompiledGraphProgram.lane_admit`.  Each call returns a new
    state and leaves the one it was given as it was.
    """

    values: torch.Tensor     # (k, V) per-lane vertex tables
    active: torch.Tensor     # (k, V) bool frontiers
    iters: np.ndarray        # (k,) supersteps executed per lane
    direction: np.ndarray    # (k,) direction register (0=pull, 1=push)
    pushes: np.ndarray       # (k,) push supersteps
    compact: np.ndarray      # (k,) compacted push supersteps
    switches: np.ndarray     # (k,) direction switches
    pe_hi: np.ndarray        # (k,) push edge counter, high 16-bit words
    pe_lo: np.ndarray        # (k,) push edge counter, low words
    pe_rows: np.ndarray      # (k, pes) live fwd-ELL rows per PE
    pl_hi: np.ndarray        # (k,) pull swept-edge counter, high words
    pl_lo: np.ndarray        # (k,) pull swept-edge counter, low words
    bl_swept: np.ndarray     # (k,) pull blocks swept (bitmap plane)
    bl_skip: np.ndarray      # (k,) pull blocks skipped
    pull_cost: np.ndarray    # (k,) measured pull-cost register


_COUNTERS = BatchLaneState._fields[2:]


@dataclasses.dataclass
class _LaneOccupancy:
    """Each lane's occupancy as of its last read (host arrays): the
    frontier's out-edges ``m_f``, vertices ``n_f``, live forward-ELL rows
    ``r_f`` (``(k, pes)``: a column a PE), and whether its table holds a
    NaN (with the probe on)."""

    m_f: np.ndarray
    n_f: np.ndarray
    r_f: np.ndarray
    nan: np.ndarray

    def copy(self) -> "_LaneOccupancy":
        return _LaneOccupancy(self.m_f.copy(), self.n_f.copy(),
                              self.r_f.copy(), self.nan.copy())


@dataclasses.dataclass
class TranslationReport:
    program: str
    backend: str                  # 'dense_cuda' | 'dense_torch' | 'sparse_torch'
    gather_module: str | None     # matched menu entry, None → general path
    reduce_module: str
    pipelines: int
    pes: int
    device: str
    translate_time_s: float
    est_flops_per_superstep: float
    est_bytes_per_superstep: float
    est_collective_bytes: int
    dsl_lines: int | None = None
    diagnostics: tuple = ()
    pass_report: str | None = None   # per-pass dump (dump_passes=True)
    ir_dump: str | None = None       # final optimized IR listing
    direction_policy: str | None = None
    directions: tuple = ("pull",)    # supersteps emitted
    run_stats: dict | None = None    # last run's direction stats
    # preprocess_s (host layouts built this call), transfer_s (layouts
    # copied to the device this call), passes_s, analysis_s, build_s
    # (CUDA kernels compiled or loaded), emit_s, total_s, preprocess_cached
    translate_breakdown: dict | None = None
    push_layout: str | None = None   # 'fwd_ell' | 'coo_chunks' with push
    push_tiers: tuple | None = None  # compaction row capacities
    pull_sweep: str = "dense"
    est_frontier_bytes: int = 0
    pull_block_tiers: tuple | None = None  # bitmap plane's m_f tier caps
    pull_blocks_total: int | None = None   # skippable blocks (bitmap plane)
    num_partitions: int = 1                # streamed partitions (1: resident)
    partition_budget_bytes: int | None = None
    # the sparse module's chunk geometry, the plan's (num_chunks, chunk_size)
    staged_chunks: tuple | None = None
    exchange_plane: str | None = None      # 'pull' | 'push' | None
    exchange_quantized: bool = False       # int8 wire on the exchange
    push_pe_rows: tuple | None = None      # forward-ELL rows a PE
    push_pe_edges: tuple | None = None     # edges a PE (balance stats)


class CompiledGraphProgram:
    """The translated executable (paper: generated HDL + host C code).

    When translation emitted both directions, :meth:`run` switches
    push ⇄ pull per superstep following the
    :class:`~repro_torch.core.scheduler.DirectionPolicy`.  Both directions
    compute the identical superstep function, so the result does not
    depend on the policy.
    """

    def __init__(self, pull_step, push_step, init_state,
                 report: TranslationReport, max_iters: int, *,
                 direction: DirectionPolicy, out_degrees, rows_per_vertex,
                 push_tiers, num_vertices: int, num_edges: int,
                 probe_divergence: bool = False, lane_step=None,
                 lane_push: bool = False, base_values=None,
                 rf_cuts: tuple | None = None,
                 comm: CommManager | None = None,
                 exchange_plane: str | None = None,
                 collective_bytes_per_superstep: int = 0,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int | None = None,
                 fingerprints_fn=None):
        # (values, active, m_f) → (new, nxt, (swept_edges, blocks_swept,
        # blocks_skipped)); each counter a Python int or a 0-d tensor
        self._pull_step = pull_step
        # (values, active, r_f) → (new, nxt, r_f) | None; r_f the live
        # forward-ELL rows a PE
        self._push_step = push_step
        self._init_state = init_state
        self._direction = direction
        self._mode = direction.mode if push_step is not None else "pull"
        self._out_degrees = out_degrees
        self._rows_per_vertex = rows_per_vertex   # None: no forward ELL
        self._push_tiers = push_tiers
        # the vertex bounds of the push plane's PEs (one PE: (0, V)); the
        # live rows of PE p are those of the frontier's vertices in
        # [rf_cuts[p], rf_cuts[p + 1])
        self._rf_cuts = rf_cuts or (0, num_vertices)
        self._npe = len(self._rf_cuts) - 1
        self._comm = comm
        self._exchange_plane = exchange_plane      # 'pull' | 'push' | None
        self._collective_bytes = int(collective_bytes_per_superstep)
        self._num_vertices = num_vertices
        self._num_edges = num_edges
        self._probe = bool(probe_divergence)
        # the batched superstep of the dense and bitmap planes ((k', V)
        # values, active, sweep rows, their pull flags, push rows, the sweep
        # rows' m_f → (new, nxt, pending pull counters)), and whether it
        # takes push rows; None and False elsewhere
        self._lane_step = lane_step
        self._lane_push = lane_push
        self._base_values = base_values      # (V,) initial table, on device
        self._host_occ_inputs = None         # lazily: host out-degrees, ...
        self._lane_memo = None               # (values, active, occupancy)
        # translate-time defaults for run(checkpoint_dir=...); the
        # fingerprint closure is lazy so un-checkpointed runs never pay
        # the graph-bytes CRC
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_every = checkpoint_every
        self._fingerprints_fn = fingerprints_fn
        self._fingerprints_cache: dict | None = None
        self.report = report
        self.max_iters = max_iters
        self.last_run_stats: dict | None = None
        self.last_run_syncs: int | None = None
        # the lane API's device→host reads (occupancy reads and the
        # snapshots' copies), batched supersteps, the lanes they stepped,
        # those that ran the batched masked sweep and those that ran the
        # batched push, since construction
        self.lane_reads = 0
        self.lane_supersteps = 0
        self.lane_steps = 0
        self.lane_sweeps = 0
        self.lane_pushes = 0

    def _fingerprints(self) -> dict:
        if self._fingerprints_cache is None:
            if self._fingerprints_fn is None:
                raise ValueError(
                    "this program was constructed without fingerprint "
                    "inputs; checkpointing needs translate()")
            self._fingerprints_cache = self._fingerprints_fn()
        return self._fingerprints_cache

    def init_state(self, roots=None, values=None):
        """``(values, active)`` on the run's device; ``values`` may be a
        numpy array or a tensor."""
        return self._init_state(roots=roots, values=values)

    def superstep(self, values, active):
        """One pull-direction superstep (the canonical form)."""
        new, nxt, _ = self._pull_step(values, active)
        return new, nxt

    def superstep_push(self, values, active):
        """One push-direction superstep."""
        if self._push_step is None:
            raise ValueError("program was translated pull-only "
                             f"({self.report.direction_policy})")
        new, nxt, _ = self._push_step(values, active)
        return new, nxt

    @property
    def _with_rf(self) -> bool:
        """Whether occupancy reads count live forward-ELL rows."""
        return self._mode != "pull" and self._rows_per_vertex is not None

    def _live_rows(self, active) -> list:
        """Live forward-ELL rows a PE of a ``(V,)`` or ``(k, V)`` frontier
        (a tensor a PE, summed over the last axis): the rows of the
        frontier's vertices inside each PE's vertex bounds."""
        rows = torch.where(active, self._rows_per_vertex, 0)
        cuts = self._rf_cuts
        return [rows[..., lo:hi].sum(-1, dtype=torch.int64)
                for lo, hi in zip(cuts[:-1], cuts[1:])]

    def _occupancy(self, active, pull_stats=()):
        """``(m_f, n_f, r_f, pull_stats)`` in one device→host transfer.

        ``m_f`` is the frontier's out-edges, ``n_f`` its vertices
        (``n_f > 0`` is the loop condition), ``r_f`` its live forward-ELL
        rows a PE (a list, zeros without a forward-ELL push twin);
        ``pull_stats`` comes back as Python ints, its tensors read in the
        same transfer.
        """
        parts = [torch.where(active, self._out_degrees, 0).sum(
                     dtype=torch.int64),
                 active.sum(dtype=torch.int64)]
        if self._with_rf:
            parts += self._live_rows(active)
        n = len(parts)
        parts += [s.reshape(()).to(torch.int64) for s in pull_stats
                  if isinstance(s, torch.Tensor)]
        host = torch.stack(parts).tolist()
        rest = iter(host[n:])
        stats = tuple(next(rest) if isinstance(s, torch.Tensor) else int(s)
                      for s in pull_stats)
        r_f = host[2:n] if n > 2 else [0] * self._npe
        return host[0], host[1], r_f, stats

    def _choose(self, prev_dir: int, m_f: int, n_f: int,
                pull_cost: int) -> int:
        """The direction register's next value (0 pull, 1 push).

        In float32, as the JAX package's staged loop computes it: past
        2^24 out-edges the rounding decides ties.  While pushing, stay
        push while ``m_f * alpha`` is below the measured pull cost (the
        last pull superstep's swept edges, E before any pull superstep).
        """
        if self._mode == "pull":
            return 0
        if self._mode == "push":
            return 1
        pol = self._direction
        if prev_dir == 1:
            return int(np.float32(m_f) * np.float32(pol.alpha)
                       < np.float32(pull_cost))
        return int(np.float32(n_f) * np.float32(pol.beta)
                   < np.float32(self._num_vertices))

    def _exchanges(self, pulls, compact):
        """Supersteps that ran the exchange: every pull superstep of a
        sharded pull plane, every compacted push superstep of a sharded
        push plane (its fallback sweep is replicated), else none."""
        return {"pull": pulls, "push": compact}.get(self._exchange_plane,
                                                    0 * pulls)

    def _scalar_stats(self, iters, pushes, compact, switches, push_edges,
                      live_rows, pull_edges, swept, skipped, pull_cost,
                      live, nanfree) -> dict:
        """run()'s stats dict from host counters, shared by :meth:`run`
        and the checkpointed slice driver so both report identically."""
        if not nanfree:
            terminated = "diverged"
        elif live and iters >= self.max_iters:
            terminated = "budget"
        else:
            terminated = "converged"
        exchanges = self._exchanges(iters - pushes, compact)
        return {
            "push_supersteps": pushes,
            "push_compacted_supersteps": compact,
            "push_fallback_supersteps": pushes - compact,
            "pull_supersteps": iters - pushes,
            "direction_switches": switches,
            "edges_traversed": pull_edges + push_edges,
            "pes": self.report.pes,
            "push_live_rows_per_pe": list(live_rows),
            "pull_blocks_swept": swept,
            "pull_blocks_skipped": skipped,
            "pull_cost_model": pull_cost,
            "exchange_supersteps": exchanges,
            "exchange_bytes": exchanges * self._collective_bytes,
            "terminated": terminated,
        }

    def _record_exchanges(self, supersteps: int, tables: int | None = None):
        """The executed exchanges on the comm manager (the
        ``comm.collective`` fault point); nothing for an unsharded plan."""
        if self._comm is not None and self._exchange_plane is not None:
            self._comm.stats.record_collective(self._collective_bytes,
                                               supersteps, tables)

    def run(self, roots=None, values=None, *, checkpoint_dir=None,
            checkpoint_every=None, resume=False):
        """Paper Algorithm 1's while-loop, on the host.

        Per-run direction stats land on ``self.last_run_stats`` and
        ``report.run_stats``, with the JAX package's keys: push/pull
        superstep counts, the compacted/fallback split of push supersteps,
        direction switches, ``edges_traversed`` (``m_f`` per push
        superstep, the swept edges per pull superstep: E on a dense
        sweep), the bitmap plane's swept/skipped blocks, the final
        measured pull-cost register and how the run ended.  The number of
        device→host reads the run made is ``self.last_run_syncs``.

        With ``checkpoint_dir=`` (here or at translate time) the run is a
        one-lane slice loop that commits a durable snapshot every
        ``checkpoint_every`` supersteps
        (:data:`~repro_torch.core.checkpoint.DEFAULT_LANE_SUPERSTEPS` by
        default); ``resume=True`` restores the newest snapshot, checked
        against this program, graph and schedule, and continues exactly.
        ``run_stats`` then gains ``checkpoint_saves``,
        ``checkpoint_loads`` and ``checkpoint_write_s``.

        Under a multi-PE plan the stats also hold the exchanges that ran
        (``exchange_supersteps``: every pull superstep of the sharded pull
        plane, every compacted push superstep of the sharded push plane;
        ``exchange_bytes``) and each PE's live rows summed over the push
        supersteps (``push_live_rows_per_pe``); the exchanges accumulate
        on the translation's comm manager.

        Each occupancy read is a ``run.read`` span, each superstep's
        enqueue a ``run.pull`` or ``run.push`` span
        (:mod:`~repro_torch.core.tracing`).
        """
        if checkpoint_dir is None:
            checkpoint_dir = self._checkpoint_dir
        if checkpoint_dir is not None:
            return self._run_checkpointed(roots, values, checkpoint_dir,
                                          checkpoint_every, resume)
        values, active = self.init_state(roots=roots, values=values)
        tiers = self._push_tiers
        it = direction = pushes = compact = switches = syncs = 0
        push_edges = pull_edges = swept = skipped = 0
        live_rows = [0] * self._npe
        pull_cost = self._num_edges
        pending = ()     # the last pull superstep's counters, read next
        probe = self._probe and values.dtype.is_floating_point
        while True:
            with tracing.span("run.read"):
                m_f, n_f, r_f, done = self._occupancy(active, pending)
            syncs += 1
            if done:
                pull_edges += done[0]
                swept += done[1]
                skipped += done[2]
                pull_cost = done[0]
            pending = ()
            live = n_f > 0
            if not live or it >= self.max_iters:
                break
            new_dir = self._choose(direction, m_f, n_f, pull_cost)
            if new_dir:
                with tracing.span("run.push"):
                    values, active, _ = self._push_step(values, active, r_f)
                pushes += 1
                # a coo_chunks push has no dense fallback: it counts as
                # compacted, as in the JAX package
                compact += int(tiers is None or max(r_f) <= tiers[-1])
                live_rows = [a + b for a, b in zip(live_rows, r_f)]
                push_edges += m_f
            else:
                with tracing.span("run.pull"):
                    values, active, pending = self._pull_step(values, active,
                                                              m_f)
            if probe:
                # a NaN anywhere freezes the frontier: the loop exits next
                # superstep and the run reads terminated='diverged'
                active = active & ~torch.isnan(values).any()
            switches += int(new_dir != direction)
            direction = new_dir
            it += 1
        nanfree = True
        if probe:
            nanfree = not bool(torch.isnan(values).any())
            syncs += 1
        stats = self._scalar_stats(it, pushes, compact, switches, push_edges,
                                   live_rows, pull_edges, swept, skipped,
                                   pull_cost, live, nanfree)
        self._record_exchanges(stats["exchange_supersteps"])
        self.last_run_stats = stats
        self.last_run_syncs = syncs
        self.report.run_stats = stats
        return values, it

    def _initial_lane_state(self, roots, values) -> BatchLaneState:
        """A one-lane :class:`BatchLaneState` for run()'s request shapes."""
        if values is None and roots is not None:
            return self.batch_init([int(np.asarray(roots))])
        v0, a0 = self.init_state(roots=roots, values=values)
        return self.batch_idle(1)._replace(values=v0[None, :],
                                           active=a0[None, :])

    def _run_checkpointed(self, roots, values, directory, every, resume):
        """run() driven through budgeted slices with durable snapshots.

        The slices step the lane through the supersteps run() would take,
        and the snapshot carries the complete 15-field lane state, so
        crash → restore → finish walks the identical superstep sequence;
        the counters ride the state, so the final ``run_stats`` merge
        across segments.  The ``lane.crash`` fault point trips at every
        slice boundary.
        """
        every = int(every or self._checkpoint_every
                    or ckpt.DEFAULT_LANE_SUPERSTEPS)
        fps = self._fingerprints()
        root_meta = None if roots is None else int(np.asarray(roots))
        saves = loads = seq = 0
        write_s = 0.0
        state = None
        if resume:
            stem = ckpt.latest_snapshot(directory, "lane")
            if stem is not None:
                manifest, arrays = ckpt.read_snapshot(stem, kind="lane",
                                                      expect=fps)
                meta = manifest["meta"]
                if meta.get("root") != root_meta:
                    raise CheckpointMismatchError(
                        f"snapshot {stem} was rooted at "
                        f"{meta.get('root')!r}, this run requests "
                        f"{root_meta!r}", field="root",
                        expected=str(root_meta), got=str(meta.get("root")))
                state = self.lane_restore(arrays)
                seq = int(manifest["seq"]) + 1
                saves = int(meta.get("checkpoint_saves", 0))
                loads = 1
        if state is None:
            state = self._initial_lane_state(roots, values)
        while not bool(self.lane_done(state)[0]):
            faults.trip("lane.crash", payload={"iters": int(state.iters[0])})
            state = self.run_batch_slice(state, every)
            t0 = time.perf_counter()
            saves += 1
            ckpt.write_snapshot(directory, "lane", seq,
                                self.lane_snapshot(state),
                                {"root": root_meta,
                                 "checkpoint_saves": saves}, fps)
            write_s += time.perf_counter() - t0
            seq += 1
        occ = self._lane_occupancy(state)
        c = {f: getattr(state, f)[0] for f in _COUNTERS}
        stats = self._scalar_stats(
            int(c["iters"]), int(c["pushes"]), int(c["compact"]),
            int(c["switches"]), (int(c["pe_hi"]) << 16) + int(c["pe_lo"]),
            c["pe_rows"].tolist(), (int(c["pl_hi"]) << 16) + int(c["pl_lo"]),
            int(c["bl_swept"]), int(c["bl_skip"]), int(c["pull_cost"]),
            bool(occ.n_f[0] > 0), not bool(occ.nan[0]))
        stats["checkpoint_saves"] = saves
        stats["checkpoint_loads"] = loads
        stats["checkpoint_write_s"] = write_s
        self.last_run_stats = stats
        self.report.run_stats = stats
        return state.values[0], int(c["iters"])

    # -- batched runs and the lane API ----------------------------------

    def run_batch(self, roots):
        """Batched Algorithm 1 over k root vertices.

        Returns ``(values (k, V) on the run's device, iters (k,) int32 on
        the host)``, each row identical to a sequential
        ``run(roots=root)``.  Converged lanes freeze (values, frontier and
        counters) while slower lanes finish; per-lane direction stats land
        on ``last_run_stats`` (lists, one entry per lane).  One
        device→host read per batched superstep serves every lane.

        Under a multi-PE plan each lane's ``exchange_supersteps`` and
        ``exchange_bytes`` are what its sequential run would count, while
        the comm manager records what the batch executed (see
        :meth:`_advance`).
        """
        state = self._advance(self.batch_init(roots), None)
        stats = self.lane_stats(state)
        self.last_run_stats = stats
        self.report.run_stats = stats
        return state.values, torch.from_numpy(state.iters.copy())

    def _batch_stats(self, state: BatchLaneState,
                     occ: _LaneOccupancy) -> dict:
        """Per-lane stats lists with the JAX package's keys; ``terminated``
        is 'converged', 'budget', 'diverged' or 'running' (a sliced lane
        that has not finished yet)."""
        iters = state.iters.astype(np.int64)
        pushes = state.pushes.astype(np.int64)
        compact = state.compact.astype(np.int64)
        pulls = iters - pushes
        push_edges = (state.pe_hi.astype(np.int64) << 16) + state.pe_lo
        pull_edges = (state.pl_hi.astype(np.int64) << 16) + state.pl_lo
        terminated = []
        for i in range(iters.shape[0]):
            if self._probe and occ.nan[i]:
                terminated.append("diverged")
            elif occ.n_f[i] == 0:
                terminated.append("converged")
            elif iters[i] >= self.max_iters:
                terminated.append("budget")
            else:
                terminated.append("running")
        exchanges = self._exchanges(pulls, compact)
        return {
            "batch_size": int(iters.shape[0]),
            "push_supersteps": pushes.tolist(),
            "push_compacted_supersteps": compact.tolist(),
            "push_fallback_supersteps": (pushes - compact).tolist(),
            "pull_supersteps": pulls.tolist(),
            "direction_switches": state.switches.astype(np.int64).tolist(),
            "edges_traversed": (pull_edges + push_edges).tolist(),
            "pes": self.report.pes,
            "push_live_rows_per_pe": state.pe_rows.astype(np.int64).tolist(),
            "pull_blocks_swept": state.bl_swept.astype(np.int64).tolist(),
            "pull_blocks_skipped": state.bl_skip.astype(np.int64).tolist(),
            # each lane's logical count (its sequential run's); what the
            # batch exchanged is on the comm manager (see run_batch)
            "exchange_supersteps": exchanges.tolist(),
            "exchange_bytes": (exchanges * self._collective_bytes).tolist(),
            "terminated": terminated,
        }

    def _host_inputs(self):
        """Host copies of what a fresh lane's occupancy is computed from:
        out-degrees, forward-ELL rows per vertex, and whether the initial
        table holds a NaN (with the probe on)."""
        if self._host_occ_inputs is None:
            deg = self._out_degrees.cpu().numpy().astype(np.int64)
            rpv = (self._rows_per_vertex.cpu().numpy().astype(np.int64)
                   if self._with_rf else np.zeros_like(deg))
            base = self._base_values
            nan = bool(self._probe and base.dtype.is_floating_point
                       and torch.isnan(base).any())
            self._host_occ_inputs = (deg, rpv, nan)
        return self._host_occ_inputs

    def _fresh_occupancy(self, roots) -> _LaneOccupancy:
        deg, rpv, nan = self._host_inputs()
        roots = np.asarray(roots, np.int64)
        k = roots.shape[0]
        # a root's rows are all on the PE whose vertex bounds hold it
        r_f = np.zeros((k, self._npe), np.int64)
        owner = np.searchsorted(np.asarray(self._rf_cuts[1:-1]), roots,
                                side="right")
        r_f[np.arange(k), owner] = rpv[roots]
        return _LaneOccupancy(m_f=deg[roots].copy(),
                              n_f=np.ones(k, np.int64), r_f=r_f,
                              nan=np.full(k, nan))

    def _remember(self, state: BatchLaneState, occ: _LaneOccupancy):
        self._lane_memo = (state.values, state.active, occ)

    def _lane_read(self, values, active, lanes, pending):
        """One device→host read: the occupancy of ``lanes`` (a list of
        lane indices, or None for all) and the pending pull counters
        ``{lane: (swept_edges, blocks_swept, blocks_skipped)}`` (tensors
        or ints).  Returns ``(m_f, n_f, r_f, nan)`` host arrays over
        ``lanes`` (``r_f`` a column a PE) and ``{lane: (ints)}``.  The
        sums run over every lane (no index tensor is copied to the device)
        and the host keeps the rows it asked for."""
        kk = active.shape[0]
        parts = [torch.where(active, self._out_degrees, 0).sum(
                     1, dtype=torch.int64),
                 active.sum(1, dtype=torch.int64)]
        if self._with_rf:
            parts += self._live_rows(active)
        probe = self._probe and values.dtype.is_floating_point
        if probe:
            parts.append(torch.isnan(values).any(1).to(torch.int64))
        tensors = [t.reshape(1).to(torch.int64)
                   for st in pending.values() for t in st
                   if isinstance(t, torch.Tensor)]
        flat = torch.cat([torch.stack(parts, 1).reshape(-1),
                          *tensors]).tolist()
        self.lane_reads += 1
        block = np.asarray(flat[:kk * len(parts)], np.int64).reshape(
            kk, len(parts))
        if lanes is not None:
            block = block[np.asarray(lanes, np.int64)]
        rest = iter(flat[kk * len(parts):])
        stats = {lane: tuple(next(rest) if isinstance(t, torch.Tensor)
                             else int(t) for t in st)
                 for lane, st in pending.items()}
        r_f = (block[:, 2:2 + self._npe] if self._with_rf
               else np.zeros((len(block), self._npe), np.int64))
        nan = block[:, -1] != 0 if probe else np.zeros(len(block), bool)
        return block[:, 0], block[:, 1], r_f, nan, stats

    def _lane_occupancy(self, state: BatchLaneState) -> _LaneOccupancy:
        """The lanes' occupancy: what the last read of this very state
        brought back, else one read now."""
        memo = self._lane_memo
        if memo is not None and memo[0] is state.values \
                and memo[1] is state.active:
            return memo[2]
        m_f, n_f, r_f, nan, _ = self._lane_read(state.values, state.active,
                                                None, {})
        occ = _LaneOccupancy(m_f, n_f, r_f, nan)
        self._remember(state, occ)
        return occ

    def batch_init(self, roots) -> BatchLaneState:
        """Root a k-lane :class:`BatchLaneState` without running any steps.

        Each lane carries the complete loop state, so slicing the batch
        with :meth:`run_batch_slice` replays the exact superstep sequence
        ``run`` would execute.
        """
        roots = np.asarray(roots, np.int64).reshape(-1)
        k, V = roots.shape[0], self._num_vertices
        base = self._base_values
        values = base.expand(k, V).clone()
        active = torch.zeros((k, V), dtype=torch.bool, device=base.device)
        for i, root in enumerate(roots.tolist()):
            # scalar fills: no index tensor copied to the device
            values[i, root] = 0
            active[i, root] = True
        z = np.zeros(k, np.int32)
        state = BatchLaneState(
            values=values, active=active, iters=z.copy(),
            direction=z.copy(), pushes=z.copy(), compact=z.copy(),
            switches=z.copy(), pe_hi=z.copy(), pe_lo=z.copy(),
            pe_rows=np.zeros((k, self._npe), np.int32), pl_hi=z.copy(),
            pl_lo=z.copy(), bl_swept=z.copy(), bl_skip=z.copy(),
            pull_cost=np.full(k, self._num_edges, np.int32))
        self._remember(state, self._fresh_occupancy(roots))
        return state

    def batch_idle(self, slots: int) -> BatchLaneState:
        """An all-idle k-lane state: every lane converged, awaiting
        :meth:`lane_admit`.  Idle lanes have an empty frontier, so they
        launch nothing."""
        state = self.batch_init(np.zeros(slots, np.int64))
        state = state._replace(active=torch.zeros_like(state.active))
        z = np.zeros(slots, np.int64)
        self._remember(state, _LaneOccupancy(
            z, z.copy(), np.zeros((slots, self._npe), np.int64),
            np.zeros(slots, bool)))
        return state

    def lane_admit(self, state: BatchLaneState, lane,
                   root) -> BatchLaneState:
        """A new state with lane ``lane`` rooted afresh at ``root``, every
        other lane as it was."""
        lane, root = int(lane), int(root)
        memo = self._lane_memo
        known = memo is not None and memo[0] is state.values \
            and memo[1] is state.active
        fresh = self.batch_init([root])
        values = state.values.clone()
        active = state.active.clone()
        values[lane] = fresh.values[0]
        active[lane] = fresh.active[0]
        counters = {}
        for f in _COUNTERS:
            arr = getattr(state, f).copy()
            arr[lane] = getattr(fresh, f)[0]
            counters[f] = arr
        out = BatchLaneState(values=values, active=active, **counters)
        if known:
            occ = memo[2].copy()
            new = self._fresh_occupancy([root])
            for name in ("m_f", "n_f", "r_f", "nan"):
                getattr(occ, name)[lane] = getattr(new, name)[0]
            self._remember(out, occ)
        return out

    def run_batch_slice(self, state: BatchLaneState,
                        budget) -> BatchLaneState:
        """Advance every live lane by at most ``budget`` supersteps.

        The slice loop is the run loop plus a step budget per lane: the
        same direction decisions, counters and freeze guards, so N slices
        concatenated step through the exact supersteps a single
        ``run_batch`` executes, including per-lane ``'auto'`` choices (the
        carried direction and pull-cost registers).  Converged lanes
        freeze; the serving plane harvests them (:meth:`lane_done`),
        frees their slots and admits queued queries without restarting
        slow lanes.  The ``lane.superstep`` fault point trips first.
        """
        faults.trip("lane.superstep")
        return self._advance(state, int(budget))

    def _advance(self, state: BatchLaneState, budget) -> BatchLaneState:
        """Step every live lane until it converges, hits ``max_iters`` or
        has taken ``budget`` supersteps (``None``: no budget).

        Each batched superstep groups the stepped lanes by route: on the
        dense and bitmap planes the sweep lanes (pull, and push past the
        largest tier) and the push lanes within a tier (when the plane
        has the lane push) go through one ``lane_step`` (on the bitmap
        plane the sweep is 2L, and the narrow pull lanes' block counters
        come back pending); every other lane (all of them on the sparse
        plane) takes its single-lane superstep.  One read per batched
        superstep brings back each stepped lane's
        occupancy and pending pull counters; the last one is remembered
        for this state, so ``lane_done``/``lane_stats`` and the next
        slice read nothing.  Under a multi-PE plan the comm manager
        records the batched supersteps that exchanged and the tables
        they carried: a batched push exchanges the batch's ``(k, V)``
        partials, a lane stepped alone its ``(V,)`` table.  A batched
        superstep's steps are one ``lane.step`` span and its read one
        ``lane.read`` span; ``lane_steps`` counts the lanes it stepped.
        """
        occ = self._lane_occupancy(state).copy()
        k = state.iters.shape[0]
        c = {f: getattr(state, f).copy() for f in _COUNTERS}
        iters, direction = c["iters"], c["direction"]
        values, active = state.values, state.active
        owned = False
        tiers = self._push_tiers
        probe = self._probe and values.dtype.is_floating_point
        device = values.device
        steps = np.zeros(k, np.int64)
        ex_steps = ex_tables = 0
        while True:
            stepping = [i for i in range(k)
                        if occ.n_f[i] > 0 and iters[i] < self.max_iters
                        and (budget is None or steps[i] < budget)]
            if not stepping:
                break
            dirs = {i: self._choose(int(direction[i]), int(occ.m_f[i]),
                                    int(occ.n_f[i]), int(c["pull_cost"][i]))
                    for i in stepping}
            sweep = [] if self._lane_step is None else [
                i for i in stepping
                if dirs[i] == 0 or (tiers is not None
                                    and occ.r_f[i].max() > tiers[-1])]
            # push lanes within a tier: one batched push when the plane
            # has it, else each its own compacted push
            pushes = [i for i in stepping
                      if i not in sweep and dirs[i]] if self._lane_push \
                else []
            singles = [i for i in stepping
                       if i not in sweep and i not in pushes]
            pending = {}
            tables = 0
            with tracing.span("lane.step"):
                if sweep or pushes:
                    # one batched superstep over those lanes, read and
                    # written in place: fresh tensors, other rows as they
                    # were; the pull lanes' counters stay pending until
                    # the read below
                    values, active, pending = self._lane_step(
                        values, active, sweep,
                        [dirs[i] == 0 for i in sweep], pushes,
                        [int(occ.m_f[i]) for i in sweep])
                    owned = True
                if sweep:
                    self.lane_sweeps += 1
                if pushes:
                    self.lane_pushes += 1
                    tables += values.shape[0] * (
                        self._exchange_plane == "push")
                if singles and not owned:
                    values, active = values.clone(), active.clone()
                    owned = True
                for i in singles:
                    if dirs[i]:
                        r_f = occ.r_f[i].tolist()
                        new, nxt, _ = self._push_step(values[i], active[i],
                                                      r_f)
                        if tiers is None or max(r_f) <= tiers[-1]:
                            tables += self._exchange_plane == "push"
                    else:
                        tables += self._exchange_plane == "pull"
                        new, nxt, pending[i] = self._pull_step(
                            values[i], active[i], int(occ.m_f[i]))
                    values[i] = new
                    active[i] = nxt
                if probe:
                    for i in stepping:
                        active[i] &= ~torch.isnan(values[i]).any()
            for i in stepping:
                d = dirs[i]
                if d:
                    r_f, m_f = occ.r_f[i], int(occ.m_f[i])
                    c["pushes"][i] += 1
                    c["compact"][i] += int(tiers is None
                                           or r_f.max() <= tiers[-1])
                    c["pe_rows"][i] += r_f.astype(np.int32)
                    c["pe_hi"][i] += m_f >> 16
                    c["pe_lo"][i] += m_f & 0xFFFF
                c["switches"][i] += int(d != direction[i])
                direction[i] = d
                iters[i] += 1
                steps[i] += 1
            ex_steps += tables > 0
            ex_tables += tables
            with tracing.span("lane.read"):
                m_f, n_f, r_f, nan, done = self._lane_read(
                    values, active, stepping, pending)
            self.lane_supersteps += 1
            self.lane_steps += len(stepping)
            for j, i in enumerate(stepping):
                occ.m_f[i], occ.n_f[i], occ.r_f[i], occ.nan[i] = \
                    m_f[j], n_f[j], r_f[j], nan[j]
            for i, (swept_e, swept_b, skip_b) in done.items():
                c["pl_hi"][i] += swept_e >> 16
                c["pl_lo"][i] += swept_e & 0xFFFF
                c["bl_swept"][i] += swept_b
                c["bl_skip"][i] += skip_b
                c["pull_cost"][i] = swept_e
        out = BatchLaneState(values=values, active=active, **c)
        self._remember(out, occ)
        self._record_exchanges(int(ex_steps), int(ex_tables))
        return out

    def lane_done(self, state: BatchLaneState) -> np.ndarray:
        """Host bool (k,): lane converged (empty frontier or max_iters)."""
        occ = self._lane_occupancy(state)
        return (occ.n_f == 0) | (state.iters >= self.max_iters)

    def lane_stats(self, state: BatchLaneState) -> dict:
        """Per-lane run stats for a sliced batch (run_batch's keys)."""
        return self._batch_stats(state, self._lane_occupancy(state))

    def lane_values(self, state: BatchLaneState, lanes) -> np.ndarray:
        """Host copies of the listed lanes' tables, ``(len(lanes), V)``,
        in one read; the other lanes stay on the device."""
        self.lane_reads += 1
        return torch.stack([state.values[i] for i in lanes]).cpu().numpy()

    def lane_snapshot(self, state: BatchLaneState) -> dict:
        """The full 15-field lane state as host numpy arrays, keyed by
        :attr:`BatchLaneState._fields`, for
        :func:`~repro_torch.core.checkpoint.write_snapshot`; it restores
        through :meth:`lane_restore` bit-exactly."""
        self.lane_reads += 1
        out = {"values": state.values.cpu().numpy(),
               "active": state.active.cpu().numpy()}
        out.update({f: np.asarray(getattr(state, f)) for f in _COUNTERS})
        return out

    def lane_restore(self, arrays: dict) -> BatchLaneState:
        """Rebuild a :class:`BatchLaneState` from :meth:`lane_snapshot`'s
        arrays (either package's).

        Dtypes are this program's (values) and the JAX package's (the rest,
        int32), not trusted from the snapshot.  Missing fields raise
        :class:`~repro_torch.errors.CheckpointCorruptError`.
        """
        missing = [f for f in BatchLaneState._fields if f not in arrays]
        if missing:
            raise CheckpointCorruptError(
                f"lane snapshot is missing carry fields: "
                f"{', '.join(missing)}", member=missing[0])
        rows = np.shape(arrays["pe_rows"])
        if rows[1:] != (self._npe,):
            raise CheckpointMismatchError(
                f"lane snapshot's pe_rows {rows} is not (k, {self._npe}): "
                f"it was taken with another PE count", field="pe_rows",
                expected=str(self._npe), got=str(rows[1:]))
        base = self._base_values
        values = torch.as_tensor(np.asarray(arrays["values"])).to(
            device=base.device, dtype=base.dtype)
        active = torch.as_tensor(np.asarray(arrays["active"]).astype(bool)
                                 ).to(base.device)
        return BatchLaneState(
            values=values, active=active,
            **{f: np.array(arrays[f], dtype=np.int32) for f in _COUNTERS})


# ---------------------------------------------------------------------------
# Translation stage: emit the reduce modules from the fused IR op
# ---------------------------------------------------------------------------


def _flat_message_mode(ir: SuperstepIR, fused: FusedGatherReduceOp,
                       program, dtype) -> str:
    """The flat sweep's per-edge message form (all give the same values):
    ``'table'`` for a weight-free gather (one gather per slot from a
    ``(V+1,)`` masked message table), ``'masked'`` when the reduce
    identity absorbs through the gather (the value table is pre-masked
    once), ``'classic'`` otherwise."""
    facts = ir.facts if ir.facts is not None else analyze_program(program)
    if facts.weight_use.value is False:
        return "table"
    if program.mask_inactive and facts.identity_absorbing.value:
        return "masked"
    return "classic"


def _emit_dense_pull_reduce(ir: SuperstepIR, fused: FusedGatherReduceOp,
                            pplan: G.PullBitmapPlan, out_deg,
                            use_kernels: bool):
    """The dense pull partial-reduce module over the flat width-8 view.

    Returns ``(partial_reduce, sub_sweep)``.  ``partial_reduce(values,
    active, need_got)`` gives the per-vertex ``(red, got)`` tables
    (``got`` is ``None`` unless asked for: eager PyTorch has no dead-code
    elimination to drop the unused any-chain).  ``sub_sweep`` reduces any
    flat block (the bitmap plane's gathered blocks too).

    With the kernels on, the ``(R8, 8)`` view streams through the CUDA
    ``edge_block_reduce`` and only the combine cascade runs as PyTorch;
    otherwise the sweep takes the message forms of
    :func:`_flat_message_mode`.  Min, max and integer add are order-free;
    a float add reduces each sub-row in lane order, then folds sub-rows in
    ascending order.
    """
    program = ir.program
    dtype = ir.value_dtype
    V = pplan.num_vertices
    ident = fused.reduce.identity.item()
    op = fused.reduce.op
    gather_module = fused.gather.module
    gather_fn = fused.gather.fn
    mode = _flat_message_mode(ir, fused, program, dtype)

    def sub_sweep(values, active, dst_blk, wgt_blk, need_any):
        """Per-sub-row ``(red, any)`` over a flat block whose PAD slots
        are baked to ``V``, the tables' always-identity dummy slot."""
        if mode == "classic":
            valid = dst_blk != V
            safe0 = torch.where(valid, dst_blk, 0)
            v = values[safe0]
            d = out_deg[safe0]
            msg = gather_fn(v, wgt_blk.to(v.dtype), d)
            live = valid
            if program.mask_inactive:
                live = live & active[safe0]
            msg = torch.where(live, msg.to(dtype), ident)
            return row_reduce_settled(op, msg, 1), torch.any(live, dim=1)
        if mode == "table":
            msg_t = pull_bitmap_kernel.message_table(
                values, out_deg, active, gather=gather_module,
                gather_fn=gather_fn, reduce=op,
                mask_inactive=program.mask_inactive, dtype=dtype)
            msg = msg_t[dst_blk]
        else:
            vmask = torch.cat([torch.where(active, values, ident),
                               torch.full((1,), ident, dtype=dtype,
                                          device=values.device)])
            deg_t = torch.cat([out_deg, torch.zeros((1,), dtype=torch.int32,
                                                    device=values.device)])
            msg = gather_fn(vmask[dst_blk], wgt_blk.to(dtype),
                            deg_t[dst_blk]).to(dtype)
        sub_any = None
        if need_any:
            if program.mask_inactive:
                live_t = torch.cat([active, torch.zeros(
                    (1,), dtype=torch.bool, device=values.device)])
                sub_any = torch.any(live_t[dst_blk], dim=1)
            else:
                sub_any = torch.any(dst_blk != V, dim=1)
        return row_reduce_settled(op, msg, 1), sub_any

    def partial_reduce(values, active, need_got=True):
        if use_kernels:
            sub_red, sub_any = edge_block_kernel.edge_block_reduce(
                pplan.flat_dst, pplan.flat_wgt, values, out_deg, active,
                gather=gather_module, reduce=op,
                mask_inactive=program.mask_inactive)
        else:
            sub_red, sub_any = sub_sweep(values, active, pplan.flat_dst_safe,
                                         pplan.flat_wgt, need_got)
        red = pull_bitmap_kernel.subrow_combine(sub_red, pplan, ident, op,
                                                dtype)
        got = None
        if need_got:
            got = pull_bitmap_kernel.subrow_combine(
                sub_any.to(torch.int8), pplan, 0, "max", torch.int8) != 0
        return red, got

    return partial_reduce, sub_sweep


def _row_mask(kk: int, rows: list, device):
    """``True``, ``False`` or a ``(kk, 1)`` bool mask of ``rows``, filled
    row by row with scalars: an index tensor would be a blocking copy to
    the device."""
    if len(rows) == kk:
        return True
    if not rows:
        return False
    mask = torch.zeros((kk, 1), dtype=torch.bool, device=device)
    for i in rows:
        mask[i] = True
    return mask


def _emit_lane_step(ir: SuperstepIR, fused: FusedGatherReduceOp,
                    pplan: G.PullBitmapPlan, out_deg, sub_sweep, apply_fn,
                    frontier_op: FrontierUpdateOp, touched_free: bool,
                    use_kernels: bool, push_op: PushScatterOp | None,
                    pe_push: tuple | None, num_edges: int,
                    bitmap: tuple | None = None):
    """The batched superstep of the lane API's dense and bitmap planes.

    Returns ``(lane_step, lane_push)``.  ``lane_step(values, active,
    sweep, pull_rows, pushes, m_f)`` maps the ``(k', V)`` state to the
    next ``(values, active, pending)``: the rows listed in ``sweep`` take
    the masked sweep, a pull superstep where their ``pull_rows`` entry is
    true and a push fallback superstep (the masked sweep, then the apply
    everywhere) otherwise; the rows in ``pushes`` take the compacted
    push's superstep; every other row is returned as it was.  All compute
    the superstep a sequential run would.  ``m_f`` lists the sweep rows'
    frontier out-edges (the occupancy read's), and ``pending`` maps each
    pull row to its ``(swept_edges, blocks_swept, blocks_skipped)``, as a
    sequential run's pull superstep counts them (0-d tensors where they
    stay on the device until the next read).  ``lane_push`` says
    whether ``pushes`` may be given (a forward-ELL push twin with a menu
    gather).

    Min, max and integer add (the order-free reduces) with a menu gather
    go through ``edge_block.edge_block_fold_lanes`` for the sweep rows and
    ``push_ell.push_ell_lanes_reduce`` for the push rows, one launch each
    for all their lanes, both combining into one ``(k', V)`` reduced
    table; the apply then runs once on the state.  A float add (and, on
    the CPU, a gather outside the menu) sweeps the listed rows with one
    launch of ``edge_block.edge_block_reduce_lanes`` (on the CPU its plain
    version for 2L's flags, else each lane's single-lane plain sweep),
    then a ``subrow_combine`` a lane that folds it in the order a
    sequential run folds it.  All read the lanes in place, through lane
    maps.  The apply runs once on a batch when the analyzer found it
    elementwise and :func:`~repro_torch.core.analysis.
    apply_batches_over_lanes` finds that a ``(2, V)`` batch of lanes gives
    each lane its own result; any other apply runs lane by lane.

    ``bitmap``, ``(fe, grid_rows)`` on the block-skipping plane (``None``
    on the dense one), gives the sweep a per-lane early-out (2L): the pull
    rows whose ``m_f`` falls in a narrow tier of
    :func:`~repro_torch.core.scheduler.pull_block_capacities` take their
    touched tables in one pass (``push_ell.push_lanes_touched``, the lane
    push's scan with a one-byte message), one flag a lane and grid block
    of ``grid_rows`` sub-rows in one more pass
    (``edge_block.lane_block_words``: a word a grid block, built on the
    card, which on the kernel path also sums the narrow lanes' counters),
    and the same sweep launch as the other sweep rows, whose bits are set
    in every word (they read every block; on root 0's BFS frontiers at
    scale 22 the one shared launch measured faster than sending them to a
    1L launch of their own at 8 lanes, and even at 32); a superstep with
    no narrow row launches 1L.  Skipping a block whose owners no active
    source reaches changes no value, so each lane's table is its
    single-lane superstep's bit for bit, and its counters are those
    :func:`_emit_pull_bitmap` counts: grid-granular on the kernel path,
    exact blocks with the ``4 · cap`` overflow on the plain path, ``E``
    edges and every block in the wide tier.  The touched table doubles as
    ``got`` when every pull row is narrow.

    ``pe_push`` is the forward-ELL push's PE group (see
    :func:`_emit_push_ell`; ``None``: no forward-ELL push twin): each
    non-empty interval runs the lane push on its PE's device (one pre-pass
    a device), the first one on the home device straight into the
    reduced table, the others into ``(k', V)`` partials that the
    collective combines into it (the order-free reduces make both the
    same).  The sweep rows stay replicated.
    """
    program = ir.program
    dtype = ir.value_dtype
    V = pplan.num_vertices
    ident = fused.reduce.identity.item()
    op = fused.reduce.op
    facts = ir.facts if ir.facts is not None else analyze_program(program)
    elementwise = bool(facts.elementwise.value) and apply_batches_over_lanes(
        apply_fn, dtype, V)
    changed = frontier_op.mode == "changed"
    masked_got = changed and not touched_free
    menu = fused.gather.module is not None
    fold = menu and dtype in (torch.int32, torch.float32) \
        and not (op == "add" and dtype.is_floating_point)
    lane_push = fold and pe_push is not None and push_op is not None \
        and push_op.gather.module is not None
    if bitmap is not None:
        fe, grid_br = bitmap
        caps = pull_block_capacities(pplan.num_blocks)
        b_total, br = pplan.num_blocks, pplan.block_rows
        if use_kernels and grid_br % br == 0:
            # each grid block's plan blocks and edges: the single-lane
            # kernel path counts its grid flags repeated to the plan blocks
            per = grid_br // br
            pad = -(-pplan.num_subrows // grid_br) * per - b_total
            grid_blocks = torch.nn.functional.pad(torch.ones_like(
                pplan.block_edges, dtype=torch.int64), (0, pad)).view(
                    -1, per).sum(1)
            grid_edges = torch.nn.functional.pad(
                pplan.block_edges.long(), (0, pad)).view(-1, per).sum(1)

    def apply_lanes(values, red, rows):
        if elementwise:
            return apply_fn(values, red)
        new = values.clone()
        for i in rows:
            new[i] = apply_fn(values[i], red[i])
        return new

    def narrow_counters(touched, counts, sweep, narrow):
        """Each narrow pull row's ``(swept_edges, blocks_swept,
        blocks_skipped)``, as the single-lane plane counts them: from the
        flags pass's ``(2, len(sweep))`` sums on the kernel path's grids of
        whole plan blocks, else from the touched tables."""
        if counts is not None:    # on the device until the superstep's read
            col = {i: j for j, i in enumerate(sweep)}
            return {i: (counts[1, col[i]], counts[0, col[i]],
                        b_total - counts[0, col[i]]) for i in narrow}
        # exact (plain path), or the odd grid's fine count
        table = torch.cat([touched, touched.new_zeros(
            (touched.shape[0], 1))], 1)           # pad owners read slot V
        live = pull_bitmap_kernel.block_liveness(table, pplan.owner8, br)
        swept_b = live.sum(1)
        swept_e = torch.where(live, pplan.block_edges, 0).sum(1)
        if use_kernels:     # on the device until the superstep's read
            skipped = b_total - swept_b
            return {i: (swept_e[i], swept_b[i], skipped[i]) for i in narrow}
        # plain path: past the gathered sweep's 4 · cap block buffer, the
        # dense sweep's counters (a host read, on the CPU)
        cnt, edges = swept_b.tolist(), swept_e.tolist()
        out = {}
        for i, m in narrow.items():
            if cnt[i] <= min(4 * caps[int(m > caps[0])], b_total):
                out[i] = (int(edges[i]), cnt[i], b_total - cnt[i])
            else:
                out[i] = (num_edges, b_total, 0)
        return out

    def skip_flags(active, sweep, pull_rows, m_f):
        """The narrow pull rows (row → m_f), 2L's flags for the sweep
        rows (``edge_block.BlockWords``; ``None``: no narrow pull row, 1L),
        their touched tables and each pull row's counters."""
        narrow = {i: m for i, pull, m in zip(sweep, pull_rows, m_f)
                  if pull and m <= caps[1]}
        pending = {i: (num_edges, b_total, 0)
                   for i, pull in zip(sweep, pull_rows)
                   if pull and i not in narrow}
        if not narrow:
            return narrow, None, None, pending
        touched = push_ell_kernel.push_lanes_touched(
            fe.row_src, fe.dst, active, list(narrow), num_rows=fe.num_rows)
        counted = use_kernels and grid_br % br == 0
        # the other sweep rows take the dense sweep: every block read
        words, counts = edge_block_kernel.lane_block_words(
            touched, pplan.owner8, sweep, grid_br,
            wide=[i for i in sweep if i not in narrow],
            grid_blocks=grid_blocks if counted else None,
            grid_edges=grid_edges if counted else None)
        pending.update(narrow_counters(touched, counts, sweep, narrow))
        return narrow, words, touched, pending

    def sweep_lanes(values, active, sweep, pulls, need_got, flags):
        """The listed rows' masked sweep (float add, unmatched gathers):
        ``(red, got)``, each lane folded alone, rows not listed the
        identity."""
        if use_kernels or (menu and flags is not None):
            sub_red, sub_any = edge_block_kernel.edge_block_reduce_lanes(
                pplan.flat_dst, pplan.flat_wgt, values, out_deg, active,
                sweep, gather=fused.gather.module, reduce=op,
                mask_inactive=program.mask_inactive, need_any=need_got,
                block_words=flags)
        else:
            parts = [sub_sweep(values[i], active[i], pplan.flat_dst_safe,
                               pplan.flat_wgt, need_got) for i in sweep]
            sub_red = [p[0] for p in parts]
            sub_any = [p[1] for p in parts]
        red = torch.full(values.shape, ident, dtype=dtype,
                         device=values.device)
        got = torch.zeros(values.shape, dtype=torch.bool,
                          device=values.device) if need_got else None
        for j, i in enumerate(sweep):
            red[i] = pull_bitmap_kernel.subrow_combine(sub_red[j], pplan,
                                                       ident, op, dtype)
            if need_got:
                got[i] = pull_bitmap_kernel.subrow_combine(
                    sub_any[j].to(torch.int8), pplan, 0, "max",
                    torch.int8) != 0
        return red, got

    def finish(values, active, red, got, stepped, pulls):
        """The apply, the touched mask of pull rows, the next frontier;
        rows outside ``stepped`` as they were."""
        kk = values.shape[0]
        stepped_m = _row_mask(kk, stepped, values.device)
        pull_m = _row_mask(kk, pulls, values.device)
        new = apply_lanes(values, red, stepped)
        if got is not None:    # pull lanes keep untouched vertices
            new = torch.where(got if pull_m is True else ~pull_m | got,
                              new, values)
        if stepped_m is not True:
            new = torch.where(stepped_m, new, values)
        nxt = new != values
        if not changed and pull_m is not False:
            nxt = nxt | pull_m      # frontier='all': pull lanes stay active
        if stepped_m is not True:
            nxt = torch.where(stepped_m, nxt, active)
        return new, nxt

    def lane_step(values, active, sweep, pull_rows, pushes, m_f):
        if pushes and not lane_push:
            raise ValueError("this program's lanes push one at a time")
        pulls = [i for i, pull in zip(sweep, pull_rows) if pull]
        narrow, flags, touched = {}, None, None
        if bitmap is None:
            pending = {i: (num_edges, 0, 0) for i in pulls}
        else:
            narrow, flags, touched, pending = skip_flags(
                active, sweep, pull_rows, m_f)
        # the pull rows' got: the touched tables when every pull row has
        # one, else the sweep's any-live flags (the same where both exist)
        need_got = masked_got and any(i not in narrow for i in pulls)
        if not fold:
            red, got = sweep_lanes(values, active, sweep, pulls, need_got,
                                   flags)
        else:
            red = torch.full(values.shape, ident, dtype=dtype,
                             device=values.device)
            got = None
            if sweep:
                red, got = edge_block_kernel.edge_block_fold_lanes(
                    pplan, values, out_deg, active, sweep,
                    gather=fused.gather.module, reduce=op,
                    mask_inactive=program.mask_inactive, need_got=need_got,
                    red=red, block_words=flags)
        if masked_got and narrow and not need_got:
            got = touched
        if pushes:
            rows_per_pe, intervals, pe_deg, devices, home, combine = pe_push
            parts, on_dev, into = [], {}, red
            for p, (rs, dst, wgt) in enumerate(intervals):
                if rows_per_pe[p] == 0:
                    continue
                d = devices[p]
                if d not in on_dev:
                    a_d = active.to(d, non_blocking=True)
                    on_dev[d] = (values.to(d, non_blocking=True), a_d,
                                 push_ell_kernel.push_lanes_prepare(
                                     a_d, pushes))
                v_d, a_d, prep = on_dev[d]
                if d != home:
                    into = None
                part = push_ell_kernel.push_ell_lanes_reduce(
                    rs, dst, wgt, v_d, pe_deg[p], a_d, pushes,
                    num_rows=rows_per_pe[p], gather=push_op.gather.module,
                    reduce=push_op.reduce.op, identity=ident, table=into,
                    prepared=prep)
                if into is None:
                    parts.append(part)
                into = None
            if parts:
                red = combine_settled(red, combine(parts, device=home), op)
        new, nxt = finish(values, active, red, got, sorted(sweep + pushes),
                          pulls)
        return new, nxt, pending

    return lane_step, lane_push


def _emit_pull_bitmap(ir: SuperstepIR, fstep: FusedSuperstepOp,
                      pplan: G.PullBitmapPlan, fe: G.ForwardELL, out_deg,
                      reduce_module, sub_sweep, use_kernels: bool,
                      num_edges: int, schedule: ScheduleConfig):
    """The fused bitmap-frontier pull superstep (block-skipping sweep).

    Returns ``(pull_superstep, caps)``.  ``pull_superstep(values, active,
    m_f)`` gives ``(new, next_active, (swept_edges, blocks_swept,
    blocks_skipped))``; ``m_f``, the frontier's out-edges, is the run
    loop's occupancy read (computed here when ``None``).

    ``m_f`` picks one of three branches, all bit-exact against the dense
    sweep: the two narrow tiers of :func:`~repro_torch.core.scheduler.
    pull_block_capacities` and the dense sweep (stats: every block swept,
    E edges).  A narrow tier builds the touched table (a compacted forward
    scatter of frontier bits, ``cap`` row slots, ``r_f <= m_f <= cap``),
    then sweeps:

    * on the plain path, as the JAX package's XLA path: exact block
      liveness, live block ids compacted through the bitmap select into
      ``4 · cap`` slots, the gathered blocks swept and expanded back
      gather-side; more live blocks than that take the dense sweep (read
      on the host: on the CPU that is no device sync);
    * on the kernel path, as its Pallas path: the whole grid through the
      early-out edge-block kernel, one liveness flag per
      ``schedule.block_rows`` sub-rows, with the skip stats rounded up to
      those grid blocks.  Its counters stay on the device until the run
      loop's next read.

    The touched table doubles as the ``got`` mask; identity-fixpoint
    applies (``fstep.touched_free``) skip the mask entirely.
    """
    fused = fstep.fused
    apply_fn = fstep.apply.fn
    touched_free = fstep.touched_free
    dtype = ir.value_dtype
    V = pplan.num_vertices
    ident = fused.reduce.identity.item()
    op = fused.reduce.op
    caps = pull_block_capacities(pplan.num_blocks)
    b_total = pplan.num_blocks
    br = pplan.block_rows
    r8p = pplan.num_subrows
    grid_br = schedule.block_rows
    device = out_deg.device
    if not use_kernels:     # the gathered path's index vectors
        lanes = torch.arange(br, dtype=torch.int64, device=device)
        sub_ids = torch.arange(r8p, dtype=torch.int64, device=device)

    def finish(values, red, got, swept_e, swept_b):
        if touched_free:
            new = apply_fn(values, red)       # untouched are fixpoints
        else:
            new = torch.where(got, apply_fn(values, red), values)
        return new, new != values, (swept_e, swept_b, b_total - swept_b)

    def sweep_gathered(cap, live, values, active):
        """Plain path: compact live block ids, gather their sub-rows."""
        selb, okb = G.bitmap_select(G.pack_bits(live), cap)
        selb = selb.long()
        rows = (selb[:, None] * br + lanes[None, :]).reshape(-1)
        okr = okb.repeat_interleave(br)
        dst_blk = torch.where(okr[:, None], pplan.flat_dst_safe[rows], V)
        sub, _ = sub_sweep(values, active, dst_blk, pplan.flat_wgt[rows],
                           False)
        # expand back to the full sub-row space gather-side: an inverse
        # map over blocks (cap entries set), then two gathers
        inv = torch.full((b_total + 1,), cap, dtype=torch.int64,
                         device=device)
        inv[torch.where(okb, selb, b_total)] = torch.where(
            okb, torch.arange(cap, device=device), cap)
        buffer = torch.cat([sub.to(dtype),
                            torch.full((br,), ident, dtype=dtype,
                                       device=device)])
        sub_full = buffer[inv[sub_ids // br] * br + sub_ids % br]
        return pull_bitmap_kernel.subrow_combine(sub_full, pplan, ident, op,
                                                 dtype)

    def sweep_kernel(touched, values, active):
        """Kernel path: full grid, in-kernel early-out per grid block."""
        grid_live = pull_bitmap_kernel.grid_block_live(touched, pplan.owner8,
                                                       grid_br)
        sub_red, _ = edge_block_kernel.edge_block_reduce(
            pplan.flat_dst, pplan.flat_wgt, values, out_deg, active,
            gather=fused.gather.module, reduce=op, mask_inactive=True,
            block_rows=grid_br, block_live=grid_live)
        red = pull_bitmap_kernel.subrow_combine(sub_red, pplan, ident, op,
                                                dtype)
        if grid_br % br == 0:
            fine_live = grid_live.repeat_interleave(grid_br // br)[:b_total]
        else:    # odd grid: account conservatively at fine granularity
            fine_live = pull_bitmap_kernel.block_liveness(
                touched, pplan.owner8, br)
        return red, fine_live

    def narrow(cap):
        block_cap = min(4 * cap, b_total)

        def f(values, active):
            touched = pull_bitmap_kernel.touched_table(
                fe.row_src, fe.dst, active, num_rows=fe.num_rows,
                capacity=cap, num_vertices=V)
            got = touched[:V] != 0
            if use_kernels:
                red, fine_live = sweep_kernel(touched, values, active)
                swept_e = torch.where(fine_live, pplan.block_edges, 0).sum()
                return finish(values, red, got, swept_e, fine_live.sum())
            live = pull_bitmap_kernel.block_liveness(touched, pplan.owner8,
                                                     br)
            cnt = int(live.sum())
            if cnt <= block_cap:
                red = sweep_gathered(block_cap, live, values, active)
                swept_e = int(torch.where(live, pplan.block_edges, 0).sum())
                return finish(values, red, got, swept_e, cnt)
            red, got_d = reduce_module(values, active,
                                       need_got=not touched_free)
            return finish(values, red, got_d, num_edges, b_total)
        return f

    def wide(values, active):
        red, got = reduce_module(values, active, need_got=not touched_free)
        return finish(values, red, got, num_edges, b_total)

    branches = (narrow(caps[0]), narrow(caps[1]), wide)

    def pull_superstep(values, active, m_f=None):
        # m_f bounds every dynamic size of a narrow tier (live forward-ELL
        # rows, touched vertices), so the tier covering it suffices
        if m_f is None:
            m_f = int(torch.where(active, out_deg, 0).sum())
        tier = int(m_f > caps[0]) + int(m_f > caps[1])
        return branches[tier](values, active)

    return pull_superstep, caps


def _emit_segment_scan_reduce(ir: SuperstepIR, fused: FusedGatherReduceOp,
                              reverse_coo: tuple, num_vertices: int,
                              num_edges: int, out_deg, splan: SchedulePlan):
    """The sparse chunk-streamed partial-reduce module.

    A host loop over the plan's ``num_chunks`` chunks of ``chunk_size``
    edges of the reverse COO (``(dst, src, wgt)``, sorted by receiving
    vertex; :meth:`~repro_torch.core.preprocess.GraphLayouts.
    reverse_coo`), where the JAX package runs ``lax.scan`` over the same
    chunks.  The loop is ``push_scatter.push_scatter_reduce`` with the
    receiving ids as destinations (every source counts as active without
    ``mask_inactive``); they ascend within a chunk, so a float add folds
    each chunk through kernel 4, the same from run to run.  Chunks are slices of the flat arrays, so no
    padded copy is kept (past the edges a chunk may be absent).  Returns
    ``(partial_reduce, chunks)``: ``partial_reduce(values, active,
    need_got, chunks=None, degrees=None)`` gives ``(red, got)`` over
    ``chunks`` (all of them by default; a PE passes its slice, on its
    device, with the out-degrees there).
    """
    program = ir.program
    ident = fused.reduce.identity.item()
    seg_dst, src, wts = reverse_coo
    starts = range(0, min(num_edges, splan.num_chunks * splan.chunk_size),
                   splan.chunk_size)
    all_chunks = [[a[s:s + splan.chunk_size] for s in starts]
                  for a in (seg_dst, src, wts)]

    def partial_reduce(values, active, need_got=True, chunks=None,
                       degrees=None):
        if not program.mask_inactive:
            active = torch.ones_like(active)
        return push_scatter_kernel.push_scatter_reduce(
            *(all_chunks if chunks is None else chunks), values,
            out_deg if degrees is None else degrees, active,
            gather_fn=fused.gather.fn, reduce=fused.reduce.op,
            identity=ident, num_vertices=num_vertices,
            dtype=ir.value_dtype, emit_touched=need_got, sorted_dst=True)

    return partial_reduce, all_chunks


def _emit_exchange(xop: ExchangeOp, partial_reduce, chunks, nchunk: int,
                   out_deg, devices: tuple, home, quantized: bool,
                   num_vertices: int):
    """The sharded pull plane: each PE scatters its slice of the chunks,
    then the PEs' partial tables combine.

    PE ``p`` takes chunks ``[p·k, (p+1)·k)``, ``k = nchunk / pes`` (the
    plan rounded ``nchunk`` to a multiple of ``pes``), copied to its
    device once here; the values and frontier follow it there each
    superstep.  The tables combine by the reduce-matched collective, or
    by :func:`~repro_torch.core.comm.quantized_psum` when ``quantized``
    (the caller sets it for a float add only, so min, max and integer add
    stay exact), and the touched masks by
    :func:`~repro_torch.core.comm.bitmap_or` of packed words below 16
    PEs, else by an int8 max, as in the JAX package.  Returns a
    partial-reduce module ``(values, active, need_got) → (red, got)`` on
    the home device.
    """
    pes = xop.pes
    k = nchunk // pes
    combine = C.quantized_psum if quantized else C.COLLECTIVES[xop.collective]
    pe_chunks = [[[c.to(d) for c in part[p * k:(p + 1) * k]]
                  for part in chunks] for p, d in enumerate(devices)]
    pe_deg = [out_deg.to(d) for d in devices]

    def sharded_reduce(values, active, need_got=True):
        reds, gots = [], []
        for p, d in enumerate(devices):
            red, got = partial_reduce(
                values.to(d, non_blocking=True),
                active.to(d, non_blocking=True), need_got,
                chunks=pe_chunks[p], degrees=pe_deg[p])
            reds.append(red)
            gots.append(got)
        red = combine(reds, device=home)
        got = None
        if need_got:
            if pes < 16:
                got = G.unpack_bits(C.bitmap_or(
                    [G.pack_bits(t) for t in gots], device=home),
                    num_vertices)
            else:
                got = C.pmax([t.to(torch.int8) for t in gots],
                             device=home) != 0
        return red, got

    return sharded_reduce


def _emit_push_scatter(ir: SuperstepIR, push_op: PushScatterOp, chunks,
                       out_deg, num_vertices: int):
    """The chunk-streamed push scatter (``layout='coo_chunks'``) over the
    forward COO's chunks ``(dst_c, src_c, wgt_c)``; every chunk is
    processed (see ``kernels/push_scatter.py``).  Returns a
    partial-reduce module ``(values, active, need_got) → (red, got)``."""
    dst_c, src_c, wgt_c = chunks
    ident = push_op.reduce.identity.item()

    def partial_reduce(values, active, need_got=True):
        return push_scatter_kernel.push_scatter_reduce(
            dst_c, src_c, wgt_c, values, out_deg, active,
            gather_fn=push_op.gather.fn, reduce=push_op.reduce.op,
            identity=ident, num_vertices=num_vertices, dtype=ir.value_dtype,
            emit_touched=need_got)

    return partial_reduce


def _emit_push_ell(ir: SuperstepIR, push_op: PushScatterOp, pe_push: tuple,
                   tiers: tuple, apply_fn, pull_reduce_module,
                   use_kernels: bool):
    """The frontier-compacted forward-ELL push superstep over a PE group.

    ``pe_push`` is ``(rows_per_pe, intervals, degrees, devices, home,
    collective)``: PE ``p`` owns the forward-ELL row interval
    ``intervals[p]`` (its ``rows_per_pe[p]`` real rows on ``devices[p]``;
    one PE owns the whole forward ELL on the run's device) and runs the
    compaction and fused messages-and-combine (kernel 3f on CUDA) on it
    into a ``(V,)`` partial on its device; the disjoint partials combine
    on the home device by the reduce-matched collective (one partial
    combines to itself).  The capacity ``tiers`` come from the largest
    interval (``rows_per_pe_max``), as in the JAX package, and each PE
    picks its own tier from its live rows.  The fallback is global: when
    any PE's live rows pass the largest tier, the whole superstep takes
    the dense sweep (the pull module, kernel 1, replicated: no exchange).
    An empty interval launches nothing (its partial is the identity).
    The compacted branches apply the reduced table everywhere and skip
    the touched mask: the fusion pass binds this layout only for an
    identity-fixpoint apply.

    Returns the superstep, which maps ``(values, active, r_f)`` to
    ``(new, next_active, r_f)``, ``r_f`` the live rows a PE (the run
    loop's occupancy read; counted here when ``None``).
    """
    dtype = ir.value_dtype
    rows_per_pe, intervals, pe_deg, devices, home, combine = pe_push
    V = pe_deg[0].shape[0]
    ident = push_op.reduce.identity.item()
    pe_src = [rs[:n].long() for (rs, _, _), n in zip(intervals, rows_per_pe)]

    def push_superstep(values, active, r_f=None):
        if r_f is None:
            r_f = [int(active.to(d)[src].sum())
                   for src, d in zip(pe_src, devices)]
        if max(r_f) > tiers[-1]:
            red, _ = pull_reduce_module(values, active, need_got=False)
        else:
            parts = []
            for p, (rs, dst, wgt) in enumerate(intervals):
                if rows_per_pe[p] == 0:
                    continue
                d = devices[p]
                v_p = values.to(d, non_blocking=True)
                live = active.to(d, non_blocking=True)[pe_src[p]]
                cap = tiers[sum(int(r_f[p] > c) for c in tiers[:-1])]
                red_p, _ = push_ell_kernel.compacted_push_reduce(
                    rs, dst, wgt, live, v_p, pe_deg[p],
                    num_rows=rows_per_pe[p], capacity=cap,
                    gather_fn=push_op.gather.fn, reduce=push_op.reduce.op,
                    identity=ident, num_vertices=V, dtype=dtype,
                    gather_module=push_op.gather.module,
                    use_kernels=use_kernels)
                parts.append(red_p)
            red = combine(parts, device=home) if parts else torch.full(
                (V,), ident, dtype=dtype, device=home)
        new = apply_fn(values, red)
        return new, new != values, r_f

    return push_superstep


# ---------------------------------------------------------------------------
# The translator
# ---------------------------------------------------------------------------


def translate(
    program: VertexProgram,
    g,
    schedule: ScheduleConfig | None = None,
    comm: CommManager | None = None,
    *,
    device=None,
    devices=None,
    dump_passes: bool = False,
    validate: bool = False,
    strict: bool = False,
    checkpoint_dir: str | None = None,
    checkpoint_every: int | None = None,
) -> CompiledGraphProgram:
    """Stage a DSL program into an executable for graph ``g`` on ``device``.

    ``device=None`` means the CUDA device and raises when there is none;
    the CUDA kernels are on exactly when the device is CUDA.  Layouts are
    built on the host once per graph (:func:`repro_torch.core.preprocess.
    layouts_for`) and copied to the device once per device.
    ``strict=True`` refuses a program carrying a warning- or error-severity
    diagnostic.  ``checkpoint_dir``/``checkpoint_every`` are the defaults
    of :meth:`CompiledGraphProgram.run`'s checkpointed runs.

    ``g`` may be a partition container (:class:`repro_torch.data.graphs.
    PartitionContainer`), and the schedule may ask for several partitions
    (``partitions`` or ``partition_budget_bytes``): both stage onto the
    streamed engine and return a :class:`~repro_torch.core.stream.
    PartitionedGraphProgram`.  ``validate=True`` checks a resident graph's
    CSR, or a container's partitions one by one.

    With ``schedule.pes > 1`` the PEs are the first ``pes`` of
    ``devices`` (default: every visible card of a CUDA run, the one CPU
    of a CPU run; fewer devices degrade the plan to fewer PEs).  A device
    may repeat: ``devices=["cpu"] * 2`` puts two PEs on the CPU,
    ``[cuda0] * 4`` four on one card.  The run's state stays on
    ``device``; every PE device must be of its type.
    """
    t0 = time.perf_counter()
    device = resolve_device(device)
    use_kernels = device.type == "cuda"
    schedule = schedule or ScheduleConfig()
    comm = comm or CommManager()
    if validate:
        if isinstance(g, G.Graph):
            G.validate_graph(g, reduce=program.reduce)
        elif hasattr(g, "validate_partitions"):
            g.validate_partitions(reduce=program.reduce)
    splan = plan(schedule, num_vertices=g.num_vertices,
                 num_edges=g.num_edges, devices=devices, device=device,
                 fixed_partitions=getattr(g, "partitions", None))
    pe_devices = splan.devices or (device,)
    if any(d.type != device.type for d in pe_devices):
        raise ValueError(f"the PE devices {[str(d) for d in pe_devices]} "
                         f"must be of the run's device type ({device}): a "
                         "PE never runs on another kind of device")
    # out-of-core dispatch: a plan over several partitions, or a source
    # that is not resident (a partition container), streams
    if splan.num_partitions > 1 or not isinstance(g, G.Graph):
        from . import stream
        return stream.translate_partitioned(
            program, g, schedule, splan, comm, device=device,
            report_cls=TranslationReport, dump_passes=dump_passes,
            strict=strict, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every)

    # ---- stages 1+2: lower to IR, run the pass pipeline -----------------
    t_passes0 = time.perf_counter()
    ctx = PassContext(schedule=schedule, plan=splan, use_kernels=use_kernels,
                      num_vertices=g.num_vertices, num_edges=g.num_edges)
    ir, pipeline_report = default_pipeline().run(
        lower_program(program), ctx, dump=dump_passes)
    passes_s = time.perf_counter() - t_passes0
    analysis_s = next((r.time_s for r in pipeline_report.records
                       if r.name == "program-analysis"), 0.0)
    if strict and max_severity(ctx.diagnostics) in ("warning", "error"):
        raise DiagnosticError(
            f"strict translation rejected {program.name!r}: " +
            "; ".join(d.render() for d in ctx.diagnostics
                      if d.severity != "info"),
            diagnostics=tuple(ctx.diagnostics))

    fstep = ir.find(FusedSuperstepOp)
    if fstep is not None:
        fused, apply_op, frontier_op = fstep.fused, fstep.apply, \
            fstep.frontier
    else:
        fused = ir.find(FusedGatherReduceOp)
        apply_op = ir.find(ApplyOp)
        frontier_op = ir.find(FrontierUpdateOp)
    if fused is None or apply_op is None or frontier_op is None:
        raise RuntimeError("pass pipeline left the IR incomplete")
    dense = fused.kernel == "edge_block"
    pull_sweep = fstep.pull_sweep if fstep is not None else "dense"
    policy = splan.direction
    push_op = ir.find(PushScatterOp) if policy.mode != "pull" else None
    push_layout = push_op.layout if push_op is not None else None
    exchange_op = ir.find(ExchangeOp)
    pes = 1 if exchange_op is None else exchange_op.pes

    # ---- stage 3: layouts, kernels, supersteps --------------------------
    t_emit0 = time.perf_counter()
    dtype = ir.value_dtype
    V = g.num_vertices
    E = g.num_edges
    lay = preprocess.layouts_for(g)
    pre_before = sum(lay.build_times_s.values())
    host = {}
    if dense:
        host["pplan"] = lay.pull_plan(schedule.pull_block_slots)
    else:
        host["rcoo"] = lay.reverse_coo()
    if push_layout == "fwd_ell" or pull_sweep == "bitmap":
        host["fe"] = lay.forward_ell(schedule.push_ell_width)
    if push_layout == "coo_chunks":
        host["fchunks"] = lay.forward_coo_chunks(splan.num_chunks)
    # a dense plan shards its push plane over forward-ELL intervals (an
    # edgeless graph's push stays replicated, as in the JAX package)
    shards = None
    if exchange_op is not None and dense and push_layout == "fwd_ell" \
            and host["fe"].num_rows >= 1:
        shards = lay.forward_ell_shards(schedule.push_ell_width, pes)
    preprocess_s = sum(lay.build_times_s.values()) - pre_before
    t_move0 = time.perf_counter()
    on = {k: lay.on(v, device) for k, v in host.items()}
    out_deg = g.out_degrees.to(device=device, dtype=torch.int32)
    pe_deg = [out_deg.to(d) for d in pe_devices]
    intervals = None if shards is None else [
        lay.on_pe(shards, p, d) for p, d in enumerate(pe_devices)]
    transfer_s = time.perf_counter() - t_move0
    build_s = 0.0
    if use_kernels and dense:
        from ..kernels import _build
        t_build0 = time.perf_counter()
        _build.library("edge_block")
        if push_layout == "fwd_ell":
            _build.library("push_ell")
        build_s = time.perf_counter() - t_build0

    sub_sweep = None
    exchange_plane, exchange_quantized, staged_chunks = None, False, None
    if dense:
        reduce_module, sub_sweep = _emit_dense_pull_reduce(
            ir, fused, on["pplan"], out_deg, use_kernels)
    else:
        reduce_module, chunks = _emit_segment_scan_reduce(
            ir, fused, on["rcoo"], V, E, out_deg, splan)
        staged_chunks = (splan.num_chunks, splan.chunk_size)
        if exchange_op is not None:
            # the int8 wire only for a float add: min, max and integer
            # add keep the exact collective
            exchange_quantized = (schedule.message_dtype == "int8"
                                  and exchange_op.collective == "psum"
                                  and dtype.is_floating_point)
            reduce_module = _emit_exchange(
                exchange_op, reduce_module, chunks, splan.num_chunks,
                out_deg, pe_devices, device, exchange_quantized, V)
            exchange_plane = "pull"
    apply_fn = apply_op.fn
    frontier_dead = frontier_op.dead
    changed = frontier_op.mode == "changed"
    touched_free = fstep.touched_free if fstep is not None else False
    need_got = changed and not touched_free

    def make_superstep(module):
        def superstep(values, active):
            red, got = module(values, active, need_got=need_got)
            new = apply_fn(values, red)
            if frontier_dead:
                # frontier='all': every vertex stays active, no change mask
                return new, torch.ones_like(active)
            if touched_free and changed:
                # identity-fixpoint apply: untouched vertices hold the
                # reduce identity, which the apply fixes, so no touched mask
                return new, new != values
            if changed:
                new = torch.where(got, new, values)
                return new, new != values
            return new, torch.ones_like(active)
        return superstep

    # ---- pull plane: the bitmap block-skipping sweep when the fusion pass
    # bound it, otherwise the dense or sparse full sweep (E edges swept)
    pull_block_tiers = pull_blocks_total = None
    if pull_sweep == "bitmap":
        pull_step, pull_block_tiers = _emit_pull_bitmap(
            ir, fstep, on["pplan"], on["fe"], out_deg, reduce_module,
            sub_sweep, use_kernels, E, schedule)
        pull_blocks_total = on["pplan"].num_blocks
    else:
        full_sweep = make_superstep(reduce_module)

        def pull_step(values, active, m_f=None):
            return (*full_sweep(values, active), (E, 0, 0))

    # ---- push twin -------------------------------------------------------
    push_step = push_tiers = rows_per_vertex = pe_push = None
    if push_layout == "fwd_ell":
        fe = on["fe"]
        if shards is not None:
            pe_push = (shards.rows_per_pe, intervals, pe_deg, pe_devices)
            rows_max = shards.rows_per_pe_max
            exchange_plane = "push"
        else:   # one PE: the whole forward ELL on the run's device
            pe_push = ((fe.num_rows,), [(fe.row_src, fe.dst, fe.weights)],
                       [out_deg], (device,))
            rows_max = fe.num_rows
        combine = C.COLLECTIVES[C.REDUCE_COLLECTIVE[push_op.reduce.op]]
        pe_push = (*pe_push, device, combine)
        push_tiers = push_capacity_tiers(rows_max)
        push_step = _emit_push_ell(ir, push_op, pe_push, push_tiers,
                                   apply_fn, reduce_module, use_kernels)
        rows_per_vertex = fe.rows_per_vertex
    elif push_layout == "coo_chunks":
        scatter_step = make_superstep(_emit_push_scatter(
            ir, push_op, on["fchunks"], out_deg, V))

        def push_step(values, active, r_f=None):
            return (*scatter_step(values, active), r_f)
    if dense and exchange_plane != "push":
        # a dense plan whose push plane did not shard (no push twin, or an
        # edgeless forward ELL) runs replicated: one PE
        pes = 1

    lane_step, lane_push = None, False
    if dense:
        fwd = push_layout == "fwd_ell"
        lane_step, lane_push = _emit_lane_step(
            ir, fused, on["pplan"], out_deg, sub_sweep, apply_fn,
            frontier_op, touched_free, use_kernels,
            push_op if fwd else None, pe_push, E,
            (on["fe"], schedule.block_rows) if pull_sweep == "bitmap"
            else None)

    base_values = program.materialize_init(V, device)

    def init_state(roots=None, values=None):
        if values is None:
            values = base_values
        elif not isinstance(values, torch.Tensor):
            values = torch.as_tensor(np.asarray(values))
        values = values.to(device=device, dtype=dtype)
        if roots is None:
            return values, torch.ones((V,), dtype=torch.bool, device=device)
        idx = torch.as_tensor(np.asarray(roots), dtype=torch.int64,
                              device=device)
        values = values.clone()
        values[idx] = 0
        active = torch.zeros((V,), dtype=torch.bool, device=device)
        active[idx] = True
        return values, active

    emit_s = time.perf_counter() - t_emit0 - preprocess_s - transfer_s \
        - build_s
    tt = time.perf_counter() - t0
    est_collective = comm.estimate_collective_bytes(
        V, dtype, pes if exchange_plane is not None else 1,
        quantized=exchange_quantized)
    # the sharded pull plane also ships the touched mask each superstep,
    # a packed bitmap below 16 PEs
    est_frontier = comm.estimate_frontier_bytes(
        V, pes if exchange_plane == "pull" else 1, packed=pes < 16)
    report = TranslationReport(
        program=program.name,
        backend=ir.backend,
        gather_module=fused.gather.module,
        reduce_module=fused.reduce.op,
        pipelines=splan.num_chunks,
        pes=pes,
        device=str(device),
        translate_time_s=tt,
        est_flops_per_superstep=2.0 * E,
        est_bytes_per_superstep=float(E * (4 + 4 + dtype.itemsize)),
        est_collective_bytes=est_collective,
        est_frontier_bytes=est_frontier,
        diagnostics=tuple(ctx.diagnostics),
        pass_report=(render_table(ctx.diagnostics, title="-- diagnostics --")
                     + "\n\n" + pipeline_report.render())
        if dump_passes else None,
        ir_dump=ir.dump(),
        direction_policy=policy.describe(),
        directions=("pull", "push") if push_step is not None else ("pull",),
        translate_breakdown={
            "preprocess_s": preprocess_s, "transfer_s": transfer_s,
            "passes_s": passes_s, "analysis_s": analysis_s,
            "build_s": build_s, "emit_s": emit_s, "total_s": tt,
            "preprocess_cached": preprocess_s == 0.0},
        push_layout=push_layout,
        push_tiers=push_tiers,
        pull_sweep=pull_sweep,
        pull_block_tiers=pull_block_tiers,
        pull_blocks_total=pull_blocks_total,
        staged_chunks=staged_chunks,
        exchange_plane=exchange_plane,
        exchange_quantized=exchange_quantized,
        push_pe_rows=None if shards is None else shards.rows_per_pe,
        push_pe_edges=None if shards is None else shards.edges_per_pe,
    )
    return CompiledGraphProgram(
        pull_step, push_step, init_state, report,
        schedule.superstep_budget(program.max_iters, V),
        direction=policy, out_degrees=out_deg,
        rows_per_vertex=rows_per_vertex, push_tiers=push_tiers,
        num_vertices=V, num_edges=E,
        probe_divergence=schedule.probe_divergence, lane_step=lane_step,
        lane_push=lane_push, base_values=base_values,
        rf_cuts=None if shards is None else shards.vertex_cuts, comm=comm,
        exchange_plane=exchange_plane,
        collective_bytes_per_superstep=est_collective + est_frontier,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        fingerprints_fn=lambda: ckpt.run_fingerprints(program, g, schedule))
