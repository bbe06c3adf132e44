"""Out-of-core partitioned execution: double-buffered interval streaming.

Counterpart of ``repro.core.stream``.  The resident translator assumes the
whole graph lives on the device; here the edge set splits into contiguous
source-vertex interval partitions (:func:`repro_torch.core.graph.
edge_interval_cuts`, planned by ``scheduler.plan``'s partition axis),
each partition's streamed ELL layouts live in a byte-budgeted host-side
:class:`~repro_torch.core.preprocess.PartitionStore` (pinned memory on
CUDA), and each superstep runs as a stream:

1. **skip before transfer**: the packed frontier is counted per interval
   (:func:`repro_torch.core.graph.interval_live_counts`); a partition
   with no live source contributes only the reduce identity, so its
   arrays never move (exact only when the program masks inactive
   sources; otherwise every partition with edges streams);
2. **double-buffered transfer**: each plane has two device buffers of its
   largest partition, allocated once a program.  A partition's arrays go
   there with ``non_blocking`` copies from the pinned store entry on a
   side CUDA stream, an event recorded after them that the compute stream
   waits on; a buffer is refilled only after the copy stream has waited
   on the event of the sweep that last read it.  Partition *i+1*'s copy
   starts before partition *i*'s sweep, so transfer rides under
   compute;
3. **partial-table combine**: each partition's sweep combines into
   running ``(k, V)`` reduced and got tables, in ascending partition
   order.

The sweeps are the port's hand-written kernels, with the state's pre-pass
(frontier words, message table) run once a superstep and handed to each
partition's launch:

* pull, min/max/int add: the fused lane sweep in accumulate mode
  (``edge_block.edge_block_fold_lanes``) over the partition's
  ``(rows, 8)`` slots as the flat view and its ``key`` as ``owner8``;
* push (min/max/int add only): the lane push
  (``push_ell.push_ell_lanes_reduce``) over the partition's forward ELL,
  ``key`` as ``row_src``, with its ``got`` output;
* pull, float add: the fused float-add fold
  (``edge_block.edge_block_add_fold_lanes``, ``csrc/stream_fold.cu``)
  over the same flat view, every lane in one launch and a carry fold:
  tiles of 256 threads x 8 rows, each row gathered and summed in slot
  order, runs of equal owners summed by a block-wide segmented scan and
  per-tile carries folded in tile order, each owner's total added into
  its running entry with a plain read and store.  The sums keep the order
  of the route it replaced (kernel 1's row sums, kernel 4's fold by
  ``key``, then ``acc + partial``) bit for bit, and there are no atomics,
  so a streamed pagerank is the same from run to run.

On the CPU the wrappers take their plain versions.  A weight-free gather
outside the menu runs on those kernels: its message table is computed
once a superstep and the kernels gather it with ``copy``.  Any other
gather outside the menu (one that reads the weight), and values of a
dtype other than int32/float32, take the general partial, as the JAX
package's streamed partial evaluates any gather: the user's gather in
PyTorch over the partition's slots, masked to the identity and reduced a
row, then on the pull plane folded by owner through kernel 4 and on the
push plane scattered to the destinations with ``scatter_reduce_``
(min, max and integer add, exact in any order; the pass pipeline never
binds push for a float add).

Bit-exactness: the finish mirrors the resident superstep case for case
(dead frontier, touched-free apply, take-if-touched, a freeze guard for
converged lanes), and min/max/int-add combines are exact in any order, so
BFS / SSSP / WCC answers and ``run_stats`` counters equal the JAX
package's streamed engine.  Float add combines partials in a fixed
ascending partition order: deterministic, reassociated against the
resident single-table sum.

The loop is host-driven, as in the JAX package: one single-lane ``'auto'``
run replays Beamer's hysteresis on the host with the measured pull-cost
register, and batched runs pin pull.  Each superstep makes one
device→host read, the liveness of its result (interval counts, ``n_f``,
``m_f``); the state it returned remembers it, so the next superstep, the
done test and the stats read nothing (counted on
:attr:`PartitionedGraphProgram.lane_reads`).
"""
from __future__ import annotations

import time
import typing

import numpy as np
import torch

from ..errors import (CheckpointCorruptError, CheckpointMismatchError,
                      ChecksumError, DiagnosticError, StreamRetryError,
                      TransientFault)
from ..kernels import edge_block as edge_block_kernel
from ..kernels import push_ell as push_ell_kernel
from ..kernels import segment_sum as segment_sum_kernel
from ..kernels.ref import (combine_settled, row_reduce_settled,
                           scatter_settled)
from . import checkpoint as ckpt
from . import faults
from . import graph as G
from . import preprocess
from . import tracing
from .analysis import analyze_program
from .comm import CommManager
from .diagnostics import max_severity, render_table
from .dsl import VertexProgram
from .ir import (ApplyOp, FrontierUpdateOp, FusedGatherReduceOp,
                 FusedSuperstepOp, PushScatterOp, lower_program)
from .passes import PassContext, default_pipeline
from .scheduler import ScheduleConfig, SchedulePlan

__all__ = ["PartitionedLaneState", "PartitionedGraphProgram",
           "translate_partitioned"]

_PLANES = ("pull", "push")


class PartitionedLaneState(typing.NamedTuple):
    """Resumable per-lane state of a partitioned batched run, the JAX
    package's 10 fields in its order and dtypes.

    ``values``/``active`` are the device carry; the counters are host
    numpy (the loop is host-driven), which is what lets ``lane_stats``
    report without a device read.  Treat them as immutable: supersteps
    replace them wholesale, so old states stay valid snapshots.
    """

    values: torch.Tensor     # (k, V) per-lane vertex tables
    active: torch.Tensor     # (k, V) bool frontiers
    iters: np.ndarray        # (k,) supersteps executed per lane
    direction: np.ndarray    # (k,) direction register (0=pull, 1=push)
    pushes: np.ndarray       # (k,) push supersteps
    switches: np.ndarray     # (k,) direction switches
    edges: np.ndarray        # (k,) logical edges traversed (int64)
    parts_swept: np.ndarray  # (k,) partition sweeps executed for the lane
    parts_skipped: np.ndarray  # (k,) partition sweeps the frontier killed
    pull_cost: np.ndarray    # (k,) measured pull-cost register (int64)


class _FlatView(typing.NamedTuple):
    """A pull partition as the fused lane sweep's flat view."""

    flat_dst: torch.Tensor
    flat_wgt: torch.Tensor
    owner8: torch.Tensor


class _Fetch(typing.NamedTuple):
    """A partition in flight: its buffer and rows, the bytes shipped, and
    the copy's timing (CUDA events, or host seconds on the CPU)."""

    slot: int
    buf: dict
    rows: int
    nbytes: int
    start: object
    end: object
    host_s: float


class _Buffers:
    """One plane's two device buffers.

    ``consumed[slot]`` is the compute-stream event of the last sweep that
    read the slot; the next copy into it waits on it first.  On the CPU
    the copies are plain (synchronous) ``copy_`` calls.
    """

    def __init__(self, device: torch.device, rows: int, width: int):
        self.bufs = [{"key": torch.empty((rows,), dtype=torch.int32,
                                         device=device),
                      "slot": torch.empty((rows, width), dtype=torch.int32,
                                          device=device),
                      "wgt": torch.empty((rows, width), dtype=torch.float32,
                                         device=device)}
                     for _ in range(2)]
        self.consumed = [None, None]


class PartitionedGraphProgram:
    """The streamed executable, the out-of-core twin of
    :class:`~repro_torch.core.translator.CompiledGraphProgram`.

    Same run surface (``init_state`` / ``superstep`` / ``run`` /
    ``run_batch`` / the lane API), different data plane: partitions
    stream from the host store through a double buffer, the frontier
    deciding per superstep which partitions move at all.
    """

    def __init__(self, program: VertexProgram,
                 store: preprocess.PartitionStore, report, max_iters: int, *,
                 device: torch.device, ir, fstep, fused, apply_op,
                 frontier_op, push_legal: bool, splan: SchedulePlan,
                 comm: CommManager, out_degrees: np.ndarray,
                 table_gather=None, general: bool = False,
                 probe_divergence: bool = False,
                 max_retries: int = 3, retry_base_s: float = 0.01,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int | None = None,
                 fingerprints_fn=None):
        self.program = program
        self.store = store
        self.report = report
        self.max_iters = max_iters
        self._device = device
        self._cuda = device.type == "cuda"
        # NaN probe: a lane whose values pick up a NaN has its frontier
        # zeroed and reports terminated='diverged'
        self._probe = bool(probe_divergence)
        # bounded exponential backoff for transient fetch failures:
        # max_retries extra attempts, sleeping retry_base_s, 2x, 4x, ...
        self._max_retries = int(max_retries)
        self._retry_base_s = float(retry_base_s)
        self.last_run_stats: dict | None = None
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_every = checkpoint_every
        self._fingerprints_fn = fingerprints_fn
        self._fingerprints_cache: dict | None = None
        self._comm = comm
        self._policy = splan.direction
        self._push_legal = push_legal
        V = store.num_vertices
        self._num_vertices = V
        self._num_edges = int(store.edges_per_partition.sum())
        self._dtype = ir.value_dtype
        self._op = fused.reduce.op
        self._ident = fused.reduce.identity.item()
        # the kernels' gather: the menu module, or 'copy' over a message
        # table computed from a weight-free gather outside the menu
        self._table_gather = table_gather
        self._gather = fused.gather.module or "copy"
        # the user's gather in PyTorch, in place of the kernels' sweeps
        self._general = general
        self._gather_fn = fused.gather.fn
        self._apply = apply_op.fn
        self._frontier_mode = frontier_op.mode
        self._frontier_dead = frontier_op.dead
        self._touched_free = fstep.touched_free if fstep is not None \
            else False
        self._need_got = (not self._frontier_dead
                          and self._frontier_mode == "changed"
                          and not self._touched_free)
        self._mask_inactive = bool(program.mask_inactive)
        self._float_add = self._op == "add" and self._dtype.is_floating_point
        self._deg_host = np.asarray(out_degrees, np.int64)
        self._deg = torch.as_tensor(self._deg_host.astype(np.int32)).to(
            device)
        self._cuts = np.asarray(store.cuts, np.int64)
        self._cuts_dev = torch.as_tensor(self._cuts).to(device)
        self._edges_per_part = np.asarray(store.edges_per_partition,
                                          np.int64)
        self._base_values = program.materialize_init(V, device).to(
            self._dtype)
        self._copy_stream = torch.cuda.Stream(device) if self._cuda \
            else None
        self._buffers: dict = {}          # plane → _Buffers, on first use
        self._memo = None                 # (active, counts, n_f, m_f)
        # device→host reads (liveness reads, the lanes' table copies),
        # streamed supersteps, the lanes they stepped, and those that
        # swept pull and push partitions, since construction
        self.lane_reads = 0
        self.lane_supersteps = 0
        self.lane_steps = 0
        self.lane_sweeps = 0
        self.lane_pushes = 0

    # -- the transfer path ---------------------------------------------------

    def _plane_buffers(self, plane: str) -> _Buffers:
        bufs = self._buffers.get(plane)
        if bufs is None:
            rows = self.store.push_rows_max if plane == "push" \
                else self.store.pull_rows_max
            bufs = _Buffers(self._device, rows, self.store.width)
            self._buffers[plane] = bufs
        return bufs

    def _start_copy(self, plane: str, p: int, slot: int, host: dict
                    ) -> _Fetch:
        """Copy one store entry into buffer ``slot`` of ``plane``."""
        bufs = self._plane_buffers(plane)
        buf = bufs.bufs[slot]
        rows = int(self.store.rows_per_partition[plane][p])
        nbytes = sum(t.numel() * t.element_size() for t in host.values())
        if not self._cuda:
            t0 = time.perf_counter()
            for name in ("key", "slot", "wgt"):
                buf[name].copy_(host[name])
            return _Fetch(slot, buf, rows, nbytes, None, None,
                          time.perf_counter() - t0)
        cs = self._copy_stream
        if bufs.consumed[slot] is not None:
            cs.wait_event(bufs.consumed[slot])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(cs):
            start.record(cs)
            for name in ("key", "slot", "wgt"):
                buf[name].copy_(host[name], non_blocking=True)
            end.record(cs)
        return _Fetch(slot, buf, rows, nbytes, start, end, 0.0)

    def _fetch_partition(self, plane: str, p: int, slot: int) -> _Fetch:
        """Build (or find) and ship one partition, with the retry ladder.

        * :class:`~repro_torch.errors.ChecksumError` (the container's CRC32
          caught a corrupt read): evict what partition ``p`` cached and
          re-read it once; a second mismatch raises.  Counted as a
          corruption.
        * :class:`~repro_torch.errors.TransientFault` (injected faults
          too) or a ``RuntimeError`` from the copy: up to ``max_retries``
          retries with exponential backoff, then
          :class:`~repro_torch.errors.StreamRetryError`.  Each retry is
          counted.
        """
        get = self.store.push_arrays if plane == "push" \
            else self.store.pull_arrays
        rebuilt = False
        attempt = 0
        while True:
            try:
                faults.trip("prefetch.device_put")
                return self._start_copy(plane, p, slot, get(p))
            except ChecksumError:
                if rebuilt:
                    raise
                rebuilt = True
                self._comm.stats.record_partition_corruption()
                self.store.evict_partition(p)
            except (TransientFault, RuntimeError) as e:
                if attempt >= self._max_retries:
                    raise StreamRetryError(
                        f"partition {p} fetch failed after "
                        f"{attempt + 1} attempts: {e}",
                        partition=p, attempts=attempt + 1) from e
                self._comm.stats.record_partition_retry()
                time.sleep(self._retry_base_s * (2 ** attempt))
                attempt += 1

    # -- the partial sweeps --------------------------------------------------

    def _messages(self, values):
        """What the kernels gather from: the values, or a weight-free
        gather's message table (outside the menu), one a lane."""
        if self._table_gather is None:
            return values
        ones = torch.ones_like(values)
        deg = self._deg.expand_as(values)
        return self._table_gather(values, ones, deg).to(self._dtype)

    def _prepare(self, plane: str, vals, active, lanes):
        """The kernels' pre-pass for this superstep's state, once."""
        if plane == "push":
            return push_ell_kernel.push_lanes_prepare(active, lanes)
        return edge_block_kernel.lanes_prepare(
            vals, self._deg, active, lanes, gather=self._gather,
            mask_inactive=self._mask_inactive)

    def _general_partial(self, plane: str, key, slot, wgt, values, active,
                         lanes, red, got):
        """One partition's partial for a gather the kernels do not take:
        the user's gather over the slots (the JAX package's streamed
        partial), each row reduced, then combined into ``red`` and
        ``got``: by owner through kernel 4 (pull) or by destination with
        ``scatter_reduce_`` (push)."""
        V, op, dtype = self._num_vertices, self._op, self._dtype
        valid = slot != G.PAD
        safe = torch.where(valid, slot, 0).long()
        src = key.long()[:, None].expand_as(slot) if plane == "push" \
            else safe
        flat = safe.reshape(-1)
        for i in lanes:
            live = valid & active[i][src] if self._mask_inactive else valid
            msg = self._gather_fn(values[i][src], wgt, self._deg[src])
            msg = torch.where(live, msg.to(dtype), self._ident)
            if plane == "push":
                red[i] = scatter_settled(red[i], 0, flat, msg.reshape(-1),
                                         op)
                if got is not None:
                    got[i] |= torch.zeros(
                        (V,), dtype=torch.int32, device=slot.device
                    ).scatter_reduce_(0, flat, live.reshape(-1).to(
                        torch.int32), "amax") > 0
                continue
            part = segment_sum_kernel.segment_reduce(
                key, row_reduce_settled(op, msg, 1), V, reduce=op)
            red[i] = combine_settled(red[i], part, op)
            if got is not None:
                got[i] |= segment_sum_kernel.segment_reduce(
                    key, live.any(1).to(torch.int32), V, reduce="max") > 0

    def _partial(self, plane: str, f: _Fetch, vals, active, lanes, red,
                 got, prep):
        """One partition's sweep of the listed lanes, combined into the
        running ``(k, V)`` tables ``red`` (and ``got``)."""
        rows = f.rows
        key = f.buf["key"][:rows]
        slot = f.buf["slot"][:rows]
        wgt = f.buf["wgt"][:rows]
        if self._general:
            self._general_partial(plane, key, slot, wgt, vals, active,
                                  lanes, red, got)
            return
        if plane == "push":
            push_ell_kernel.push_ell_lanes_reduce(
                key, slot, wgt, vals, self._deg, active, lanes,
                num_rows=rows, gather=self._gather, reduce=self._op,
                identity=self._ident, table=red, got=got, prepared=prep)
            return
        view = _FlatView(slot, wgt, key)
        if self._float_add:
            edge_block_kernel.edge_block_add_fold_lanes(
                view, vals, self._deg, active, lanes, gather=self._gather,
                mask_inactive=self._mask_inactive, red=red, got=got,
                prepared=prep)
            return
        edge_block_kernel.edge_block_fold_lanes(
            view, vals, self._deg, active, lanes, gather=self._gather,
            reduce=self._op, mask_inactive=self._mask_inactive,
            need_got=got is not None, red=red, got=got, accumulate=True,
            prepared=prep)

    def _sweep(self, values, active, lanes, parts, plane, *, trip: bool):
        """Stream ``parts`` of ``plane`` past the lanes ``lanes``; returns
        ``(red, got, fetches, compute)``: the combined tables, the
        partitions shipped, and the compute timings (event pairs, or host
        seconds)."""
        k, V = values.shape
        red = torch.full((k, V), self._ident, dtype=self._dtype,
                         device=values.device)
        got = torch.zeros((k, V), dtype=torch.bool, device=values.device) \
            if self._need_got else None
        fetches, compute = [], []
        if not parts or not lanes:
            return red, got, fetches, compute
        if self._general:
            vals, prep = values, None
        else:
            vals = self._messages(values)
            prep = self._prepare(plane, vals, active, lanes)
        bufs = self._plane_buffers(plane)
        pending = None
        for i, p in enumerate(parts):
            if pending is None:
                pending = self._fetch_partition(plane, p, i % 2)
            cur, pending = pending, None
            if i + 1 < len(parts):
                pending = self._fetch_partition(plane, parts[i + 1],
                                                (i + 1) % 2)
            fetches.append(cur)
            if self._cuda:
                stream = torch.cuda.current_stream(values.device)
                stream.wait_event(cur.end)
                c0 = torch.cuda.Event(enable_timing=True)
                c1 = torch.cuda.Event(enable_timing=True)
                c0.record(stream)
                self._partial(plane, cur, vals, active, lanes, red, got,
                              prep)
                c1.record(stream)
                bufs.consumed[cur.slot] = c1
                compute.append((c0, c1))
            else:
                t0 = time.perf_counter()
                self._partial(plane, cur, vals, active, lanes, red, got,
                              prep)
                compute.append(time.perf_counter() - t0)
            if trip:
                # a partition-boundary crash, outside the fetch's retry
                # ladder: the superstep's partials die with it and are
                # re-derived on resume
                faults.trip("lane.crash", payload={"partition": p})
        return red, got, fetches, compute

    def _finish(self, values, active, red, got, lanes):
        """Apply and frontier from the combined partials, the resident
        superstep's finish a lane; lanes not listed as they were."""
        new_v, new_a = values.clone(), active.clone()
        for i in lanes:
            v = values[i]
            new = self._apply(v, red[i]).to(self._dtype)
            if self._frontier_dead:
                nxt = torch.ones_like(active[i])
            elif self._touched_free and self._frontier_mode == "changed":
                nxt = new != v
            else:
                changed = self._frontier_mode == "changed"
                if changed:
                    new = torch.where(got[i], new, v)
                nxt = new != v if changed else torch.ones_like(active[i])
            new_v[i] = new
            new_a[i] = nxt
        return new_v, new_a

    # -- liveness: the one device→host read of a superstep --------------------

    def _liveness(self, active):
        """``(counts (k, P), n_f (k,), m_f (k,))`` on the host, in one
        read: the frontier packed and counted per interval, its vertices
        and its out-edges."""
        k = active.shape[0]
        P = self.store.partitions
        counts = G.interval_live_counts(G.pack_bits(active), self._cuts_dev)
        n_f = active.sum(1, dtype=torch.int64)
        m_f = torch.where(active, self._deg, 0).sum(1, dtype=torch.int64)
        host = torch.cat([counts.reshape(-1).to(torch.int64), n_f,
                          m_f]).cpu().numpy()
        self.lane_reads += 1
        return (host[:k * P].reshape(k, P), host[k * P:k * P + k],
                host[k * P + k:])

    def _host_liveness(self, roots):
        """The liveness of freshly rooted lanes, from the host alone."""
        roots = np.asarray(roots, np.int64)
        k, P = len(roots), self.store.partitions
        counts = np.zeros((k, P), np.int64)
        part = np.searchsorted(self._cuts[1:], roots, side="right")
        counts[np.arange(k), part] = 1
        return counts, np.ones(k, np.int64), self._deg_host[roots].copy()

    def _remember(self, state: PartitionedLaneState, live) -> None:
        self._memo = (state.active, *live)

    def _state_liveness(self, state: PartitionedLaneState):
        memo = self._memo
        if memo is not None and memo[0] is state.active:
            return memo[1:]
        live = self._liveness(state.active)
        self._remember(state, live)
        return live

    # -- resident-compatible surface -------------------------------------------

    def init_state(self, roots=None, values=None):
        """``(values (V,), active (V,))`` on the run's device."""
        if values is None:
            values = self._base_values
        elif not isinstance(values, torch.Tensor):
            values = torch.as_tensor(np.asarray(values))
        values = values.to(device=self._device, dtype=self._dtype)
        V = self._num_vertices
        if roots is None:
            return values, torch.ones((V,), dtype=torch.bool,
                                      device=self._device)
        values = values.clone()
        active = torch.zeros((V,), dtype=torch.bool, device=self._device)
        for r in np.atleast_1d(np.asarray(roots)).tolist():
            values[int(r)] = 0
            active[int(r)] = True
        return values, active

    def superstep(self, values, active):
        """One full (no-skip) pull superstep over every partition."""
        v, a = values[None, :], active[None, :]
        red, got, _, _ = self._sweep(v, a, [0],
                                     list(range(self.store.partitions)),
                                     "pull", trip=False)
        new, nxt = self._finish(v, a, red, got, [0])
        return new[0], nxt[0]

    # -- the streamed superstep ------------------------------------------------

    def _live_partitions(self, counts: np.ndarray,
                         alive: np.ndarray) -> list[int]:
        """Skip before transfer: the partitions this superstep moves.

        Under ``mask_inactive`` the interval counts are exact: a partition
        with no live source across the alive lanes gives an all-identity
        partial.  Without it inactive sources still send, so every
        partition with edges streams.
        """
        has_edges = self._edges_per_part > 0
        if self._mask_inactive:
            live = counts[alive].sum(axis=0) > 0 if alive.any() \
                else np.zeros_like(has_edges)
            return [int(p) for p in np.nonzero(live & has_edges)[0]]
        return [int(p) for p in np.nonzero(has_edges)[0]]

    def _choose_direction(self, state: PartitionedLaneState,
                          n_f: np.ndarray, m_f: np.ndarray,
                          alive: np.ndarray) -> int:
        """The plane of this streamed superstep (0 pull, 1 push).

        A single lane's ``'auto'`` replays the resident hysteresis on the
        host: enter push while ``n_f * beta < V``, stay while ``m_f *
        alpha`` undercuts the measured pull cost (the live partitions'
        edges of the last pull sweep).  The plane is global to the
        stream, so batched ``'auto'`` pins pull; values are bit-exact on
        either plane.
        """
        if not self._push_legal or self._policy.mode == "pull":
            return 0
        if self._policy.mode == "push":
            return 1
        if len(alive) != 1:
            return 0
        if not alive[0]:
            return int(state.direction[0])
        if state.direction[0] == 1:
            stay = int(m_f[0]) * self._policy.alpha < int(state.pull_cost[0])
            return 1 if stay else 0
        enter = int(n_f[0]) * self._policy.beta < self._num_vertices
        return 1 if enter else 0

    def _advance(self, state: PartitionedLaneState,
                 budget: int | None) -> PartitionedLaneState:
        """Run up to ``budget`` streamed supersteps (None: to the end).

        A superstep's sweep is one ``lane.step`` span and its liveness read
        one ``lane.read`` span; ``lane_steps`` counts the lanes it stepped.
        """
        counts, n_f, m_f = self._state_liveness(state)
        P = self.store.partitions
        steps = 0
        while budget is None or steps < budget:
            alive = (n_f > 0) & (state.iters < self.max_iters)
            if not alive.any():
                break
            faults.trip("lane.superstep")
            # superstep-boundary crash point: checkpoints commit only at
            # boundaries, so a crash here resumes from the last snapshot
            faults.trip("lane.crash",
                        payload={"superstep": int(state.iters[0])})
            direction = self._choose_direction(state, n_f, m_f, alive)
            plane = _PLANES[direction]
            live_parts = self._live_partitions(counts, alive)
            lanes = [int(i) for i in np.nonzero(alive)[0]]
            t_wall = time.perf_counter()
            with tracing.span("lane.step"):
                red, got, fetches, compute = self._sweep(
                    state.values, state.active, lanes, live_parts, plane,
                    trip=True)
                values, active = self._finish(state.values, state.active,
                                              red, got, lanes)
                if self._probe and self._dtype.is_floating_point:
                    # a lane whose table picked up a NaN freezes (partial
                    # values kept) and reports terminated='diverged'
                    active &= ~torch.isnan(values).any(1, keepdim=True)
            with tracing.span("lane.read"):
                new_live = self._liveness(active)
            wall_s = time.perf_counter() - t_wall
            stats = self._comm.stats
            for f in fetches:
                secs = f.host_s if f.start is None \
                    else f.start.elapsed_time(f.end) / 1e3
                stats.record_partition_h2d(f.nbytes, secs)
            compute_s = sum(c if isinstance(c, float)
                            else c[0].elapsed_time(c[1]) / 1e3
                            for c in compute)
            stats.record_partition_skip(P - len(live_parts))
            stats.record_partition_superstep(wall_s, compute_s)
            self.lane_supersteps += 1
            self.lane_steps += len(lanes)
            if live_parts:
                if direction:
                    self.lane_pushes += 1
                else:
                    self.lane_sweeps += 1
            # the host counters roll forward (copies: old states stay
            # snapshots); a push superstep traverses the lane's frontier
            # out-edges, a pull sweep its own live partitions' edges
            lane_live = counts > 0 if self._mask_inactive \
                else np.ones_like(counts, bool)
            lane_pull_edges = (lane_live
                               * self._edges_per_part[None, :]).sum(axis=1)
            state = PartitionedLaneState(
                values=values, active=active, iters=state.iters + alive,
                direction=np.where(alive, direction,
                                   state.direction).astype(np.int32),
                pushes=state.pushes + (alive if direction == 1 else 0),
                switches=state.switches + (
                    alive & (state.direction != direction)
                    & (state.iters > 0)),
                edges=state.edges + np.where(
                    alive, m_f if direction == 1 else lane_pull_edges, 0),
                parts_swept=state.parts_swept + np.where(
                    alive, len(live_parts), 0),
                parts_skipped=state.parts_skipped + np.where(
                    alive, P - len(live_parts), 0),
                pull_cost=np.where(alive & (direction == 0),
                                   lane_pull_edges, state.pull_cost))
            counts, n_f, m_f = new_live
            steps += 1
        self._remember(state, (counts, n_f, m_f))
        return state

    # -- run / run_batch -------------------------------------------------------

    def _fresh_state(self, roots) -> PartitionedLaneState:
        roots = np.atleast_1d(np.asarray(roots, np.int64))
        k, V = len(roots), self._num_vertices
        values = self._base_values.expand(k, V).clone()
        active = torch.zeros((k, V), dtype=torch.bool, device=self._device)
        for i, r in enumerate(roots.tolist()):
            # scalar fills: no index tensor copied to the device
            values[i, r] = 0
            active[i, r] = True
        z = np.zeros(k, np.int64)
        state = PartitionedLaneState(
            values=values, active=active, iters=z.copy(),
            direction=np.zeros(k, np.int32), pushes=z.copy(),
            switches=z.copy(), edges=z.copy(), parts_swept=z.copy(),
            parts_skipped=z.copy(),
            pull_cost=np.full(k, self._num_edges, np.int64))
        self._remember(state, self._host_liveness(roots))
        return state

    def _single_state(self, values, active, live) -> PartitionedLaneState:
        z = np.zeros(1, np.int64)
        state = PartitionedLaneState(
            values=values[None, :], active=active[None, :], iters=z.copy(),
            direction=np.zeros(1, np.int32), pushes=z.copy(),
            switches=z.copy(), edges=z.copy(), parts_swept=z.copy(),
            parts_skipped=z.copy(),
            pull_cost=np.full(1, self._num_edges, np.int64))
        self._remember(state, live)
        return state

    def _initial_state(self, roots, values) -> PartitionedLaneState:
        """A one-lane state for run()'s request shapes."""
        if values is None and roots is not None:
            state = self._fresh_state(roots)
            if state.values.shape[0] != 1:
                raise ValueError("run() takes a single root; use run_batch")
            return state
        v0, a0 = self.init_state(roots=roots, values=values)
        if roots is None:       # every vertex active
            live = (np.diff(self._cuts)[None, :].astype(np.int64),
                    np.full(1, self._num_vertices, np.int64),
                    np.full(1, int(self._deg_host.sum()), np.int64))
        else:
            counts, n_f, m_f = self._host_liveness(
                np.unique(np.atleast_1d(np.asarray(roots, np.int64))))
            live = (counts.sum(0, keepdims=True), n_f.sum(keepdims=True),
                    m_f.sum(keepdims=True))
        return self._single_state(v0, a0, live)

    def _comm_counters(self) -> tuple:
        """The 8 partition-plane comm counters a run's stats diff."""
        s = self._comm.stats
        return (s.partition_bytes_h2d, s.partitions_transferred,
                s.partitions_skipped, s.partition_prefetch_s,
                s.partition_compute_s, s.partition_wall_s,
                s.partition_retries, s.partition_corruptions)

    def run(self, roots=None, values=None, *, checkpoint_dir=None,
            checkpoint_every=None, resume=False):
        """Algorithm 1 over the partition stream; resident-compatible.

        Returns ``(values (V,) on the device, iters)``; ``last_run_stats``
        carries the resident keys plus the partition plane's (partitions
        swept and skipped, bytes streamed, transfer/compute/wall seconds,
        overlap efficiency, the store's report).  With ``checkpoint_dir``
        (here or at translate time) a snapshot of the lane carry commits
        every ``checkpoint_every`` partition sweeps (default
        :data:`~repro_torch.core.checkpoint.DEFAULT_STREAM_SWEEPS`);
        ``resume=True`` restores the newest one and continues bit-exactly.
        """
        if checkpoint_dir is None:
            checkpoint_dir = self._checkpoint_dir
        state = self._initial_state(roots, values)
        base = self._comm_counters()
        if checkpoint_dir is not None:
            return self._run_checkpointed(state, roots, checkpoint_dir,
                                          checkpoint_every, resume, base)
        state = self._advance(state, None)
        stats = self._run_stats(state, lane=0, base=base)
        self.last_run_stats = stats
        self.report.run_stats = stats
        return state.values[0], int(state.iters[0])

    def _fingerprints(self) -> dict:
        if self._fingerprints_cache is None:
            if self._fingerprints_fn is None:
                raise ValueError(
                    "this program was constructed without fingerprint "
                    "inputs; checkpointing needs translate()")
            self._fingerprints_cache = self._fingerprints_fn()
        return self._fingerprints_cache

    def _run_checkpointed(self, state, roots, directory, every, resume,
                          base):
        """run() with durable snapshots every ``every`` partition sweeps.

        Checkpoints commit at superstep boundaries, the only points where
        the carry is whole; a crash mid-sweep loses that superstep's
        partials, which re-execution re-derives.  The manifest carries the
        comm counters as ``carried + (current - base)``, so a resumed run
        reports an uninterrupted one's totals.
        """
        every = int(every or self._checkpoint_every
                    or ckpt.DEFAULT_STREAM_SWEEPS)
        fps = self._fingerprints()
        root_meta = (None if roots is None
                     else int(np.atleast_1d(np.asarray(roots))[0]))
        saves = loads = seq = 0
        write_s = 0.0
        carry = (0, 0, 0, 0.0, 0.0, 0.0, 0, 0)
        if resume:
            stem = ckpt.latest_snapshot(directory, "stream")
            if stem is not None:
                manifest, arrays = ckpt.read_snapshot(stem, kind="stream",
                                                      expect=fps)
                meta = manifest["meta"]
                if meta.get("root") != root_meta:
                    raise CheckpointMismatchError(
                        f"snapshot {stem} was rooted at "
                        f"{meta.get('root')!r}, this run requests "
                        f"{root_meta!r}", field="root",
                        expected=str(root_meta),
                        got=str(meta.get("root")))
                state = self.lane_restore(arrays)
                seq = int(manifest["seq"]) + 1
                saves = int(meta.get("checkpoint_saves", 0))
                carry = tuple(meta.get("comm", carry))
                loads = 1
        last_swept = int(state.parts_swept[0])
        while not bool(self.lane_done(state)[0]):
            state = self._advance(state, 1)
            done = bool(self.lane_done(state)[0])
            if int(state.parts_swept[0]) - last_swept >= every or done:
                cur = self._comm_counters()
                merged = [c + (n - b) for c, n, b in zip(carry, cur, base)]
                t0 = time.perf_counter()
                saves += 1
                ckpt.write_snapshot(directory, "stream", seq,
                                    self.lane_snapshot(state),
                                    {"root": root_meta, "comm": merged,
                                     "checkpoint_saves": saves}, fps)
                write_s += time.perf_counter() - t0
                seq += 1
                last_swept = int(state.parts_swept[0])
        stats = self._run_stats(state, lane=0, base=base, carry=carry)
        stats["checkpoint_saves"] = saves
        stats["checkpoint_loads"] = loads
        stats["checkpoint_write_s"] = write_s
        self.last_run_stats = stats
        self.report.run_stats = stats
        return state.values[0], int(state.iters[0])

    def run_batch(self, roots):
        """Batched Algorithm 1 over the stream: k lanes share each
        superstep's union of live partitions (a partition dead for one
        lane gives that lane only the identity).  Per-lane stats stay
        logical (the lane's own live partitions); ``'auto'`` pins pull.
        Returns ``(values (k, V) on the device, iters (k,) on the
        host)``."""
        state = self._advance(self._fresh_state(roots), None)
        stats = self._batch_stats(state)
        self.last_run_stats = stats
        self.report.run_stats = stats
        return state.values, torch.from_numpy(state.iters.copy())

    def _terminated(self, state: PartitionedLaneState) -> list[str]:
        """Per-lane exit classification (the JAX package's)."""
        _, n_f, _ = self._state_liveness(state)
        if self._probe and self._dtype.is_floating_point:
            nan = torch.isnan(state.values).any(1).cpu().numpy()
            self.lane_reads += 1
        else:
            nan = np.zeros(len(n_f), bool)
        out = []
        for i in range(len(n_f)):
            if nan[i]:
                out.append("diverged")
            elif n_f[i] == 0:
                out.append("converged")
            elif int(state.iters[i]) >= self.max_iters:
                out.append("budget")
            else:
                out.append("running")
        return out

    def _run_stats(self, state: PartitionedLaneState, lane: int,
                   base: tuple, carry: tuple | None = None) -> dict:
        # carry: comm totals restored from a snapshot manifest, the
        # earlier crash segments' deltas
        if carry is None:
            carry = (0, 0, 0, 0.0, 0.0, 0.0, 0, 0)
        s = self._comm.stats
        d_bytes = carry[0] + s.partition_bytes_h2d - base[0]
        d_moved = carry[1] + s.partitions_transferred - base[1]
        prefetch_s = carry[3] + s.partition_prefetch_s - base[3]
        compute_s = carry[4] + s.partition_compute_s - base[4]
        wall_s = carry[5] + s.partition_wall_s - base[5]
        shorter = min(prefetch_s, compute_s)
        overlap = 0.0 if shorter <= 0 or wall_s <= 0 else float(
            np.clip((prefetch_s + compute_s - wall_s) / shorter, 0.0, 1.0))
        pushes = int(state.pushes[lane])
        return {
            "push_supersteps": pushes,
            "push_compacted_supersteps": pushes,
            "push_fallback_supersteps": 0,
            "pull_supersteps": int(state.iters[lane]) - pushes,
            "direction_switches": int(state.switches[lane]),
            "edges_traversed": int(state.edges[lane]),
            "pes": 1,
            "push_live_rows_per_pe": [0],
            "pull_blocks_swept": 0,
            "pull_blocks_skipped": 0,
            "pull_cost_model": int(state.pull_cost[lane]),
            "exchange_supersteps": 0,
            "exchange_bytes": 0,
            "partitions": self.store.partitions,
            "partitions_swept": int(state.parts_swept[lane]),
            "partitions_skipped": int(state.parts_skipped[lane]),
            "partition_bytes_h2d": int(d_bytes),
            "partitions_transferred": int(d_moved),
            "partition_transfer_s": prefetch_s,
            "partition_compute_s": compute_s,
            "partition_wall_s": wall_s,
            "overlap_efficiency": overlap,
            "partition_retries": int(
                carry[6] + s.partition_retries - base[6]),
            "partition_corruptions": int(
                carry[7] + s.partition_corruptions - base[7]),
            "terminated": self._terminated(state)[lane],
            "partition_store": self.store.stats(),
        }

    def _batch_stats(self, state: PartitionedLaneState) -> dict:
        pushes = state.pushes.astype(np.int64)
        return {
            "batch_size": int(state.iters.shape[0]),
            "push_supersteps": pushes.tolist(),
            "pull_supersteps": (state.iters - pushes).tolist(),
            "direction_switches": state.switches.tolist(),
            "edges_traversed": state.edges.tolist(),
            "pes": 1,
            "partitions": self.store.partitions,
            "partitions_swept": state.parts_swept.tolist(),
            "partitions_skipped": state.parts_skipped.tolist(),
            "terminated": self._terminated(state),
            "partition_store": self.store.stats(),
        }

    # -- lane-level continuation (serving plane) --------------------------------

    def batch_init(self, roots) -> PartitionedLaneState:
        """Root a k-lane state without running any supersteps."""
        return self._fresh_state(np.asarray(roots))

    def batch_idle(self, slots: int) -> PartitionedLaneState:
        """All-idle k-lane state: empty frontiers, awaiting admits."""
        state = self._fresh_state(np.zeros(slots, np.int64))
        state = state._replace(active=torch.zeros_like(state.active))
        z = np.zeros(slots, np.int64)
        self._remember(state, (np.zeros((slots, self.store.partitions),
                                        np.int64), z, z.copy()))
        return state

    def lane_admit(self, state: PartitionedLaneState, lane,
                   root) -> PartitionedLaneState:
        """Overwrite one lane with a freshly rooted query, others as they
        were."""
        lane, root = int(lane), int(root)
        memo = self._memo
        known = memo is not None and memo[0] is state.active
        values = state.values.clone()
        active = state.active.clone()
        values[lane] = self._base_values
        values[lane, root] = 0
        active[lane] = False
        active[lane, root] = True

        def reset(a, fill=0):
            out = a.copy()
            out[lane] = fill
            return out

        out = PartitionedLaneState(
            values=values, active=active, iters=reset(state.iters),
            direction=reset(state.direction), pushes=reset(state.pushes),
            switches=reset(state.switches), edges=reset(state.edges),
            parts_swept=reset(state.parts_swept),
            parts_skipped=reset(state.parts_skipped),
            pull_cost=reset(state.pull_cost, self._num_edges))
        if known:
            counts, n_f, m_f = (a.copy() for a in memo[1:])
            fresh = self._host_liveness([root])
            counts[lane], n_f[lane], m_f[lane] = (fresh[0][0], fresh[1][0],
                                                  fresh[2][0])
            self._remember(out, (counts, n_f, m_f))
        return out

    def run_batch_slice(self, state: PartitionedLaneState,
                        budget) -> PartitionedLaneState:
        """Advance every live lane by at most ``budget`` supersteps: the
        exact superstep sequence :meth:`run_batch` runs (same liveness,
        plane and freeze decisions), so a lane that converges mid-stream
        harvests the answer a straight-through run gives."""
        return self._advance(state, int(budget))

    def lane_done(self, state: PartitionedLaneState) -> np.ndarray:
        """Host bool (k,): lane converged (empty frontier or max_iters)."""
        _, n_f, _ = self._state_liveness(state)
        return (n_f == 0) | (state.iters >= self.max_iters)

    def lane_stats(self, state: PartitionedLaneState) -> dict:
        """Per-lane stats lists (harvested by the serving plane)."""
        return self._batch_stats(state)

    def lane_values(self, state: PartitionedLaneState, lanes) -> np.ndarray:
        """Host copies of the listed lanes' tables, ``(len(lanes), V)``,
        in one read; the other lanes stay on the device."""
        self.lane_reads += 1
        return torch.stack([state.values[i] for i in lanes]).cpu().numpy()

    def lane_snapshot(self, state: PartitionedLaneState) -> dict:
        """The full 10-field streamed carry as host numpy arrays, keyed by
        :attr:`PartitionedLaneState._fields`; restores bit-exactly through
        :meth:`lane_restore` (in either package), direction and pull-cost
        registers included."""
        self.lane_reads += 1
        out = {"values": state.values.cpu().numpy(),
               "active": state.active.cpu().numpy()}
        for name in PartitionedLaneState._fields[2:]:
            out[name] = np.array(getattr(state, name), copy=True)
        return out

    def lane_restore(self, arrays: dict) -> PartitionedLaneState:
        """Rebuild a :class:`PartitionedLaneState` from
        :meth:`lane_snapshot`'s arrays (either package's).  Dtypes are
        this program's, not trusted from the snapshot; missing fields
        raise :class:`~repro_torch.errors.CheckpointCorruptError`."""
        missing = [f for f in PartitionedLaneState._fields
                   if f not in arrays]
        if missing:
            raise CheckpointCorruptError(
                f"stream snapshot is missing carry fields: "
                f"{', '.join(missing)}", member=missing[0])
        return PartitionedLaneState(
            values=torch.as_tensor(np.asarray(arrays["values"])).to(
                device=self._device, dtype=self._dtype),
            active=torch.as_tensor(np.asarray(arrays["active"]).astype(
                bool)).to(self._device),
            iters=np.asarray(arrays["iters"], np.int64),
            direction=np.asarray(arrays["direction"], np.int32),
            pushes=np.asarray(arrays["pushes"], np.int64),
            switches=np.asarray(arrays["switches"], np.int64),
            edges=np.asarray(arrays["edges"], np.int64),
            parts_swept=np.asarray(arrays["parts_swept"], np.int64),
            parts_skipped=np.asarray(arrays["parts_skipped"], np.int64),
            pull_cost=np.asarray(arrays["pull_cost"], np.int64))


def translate_partitioned(program: VertexProgram, source,
                          schedule: ScheduleConfig, splan: SchedulePlan,
                          comm: CommManager, *, device: torch.device,
                          report_cls, dump_passes: bool = False,
                          strict: bool = False,
                          checkpoint_dir: str | None = None,
                          checkpoint_every: int | None = None
                          ) -> PartitionedGraphProgram:
    """Stage a DSL program onto the partition stream.

    ``source`` is a resident :class:`~repro_torch.core.graph.Graph`
    (partitioned by the plan's interval cuts) or a partition container (a
    ``partition_coo(p)`` / ``cuts`` / ``out_degrees`` provider, such as
    :class:`repro_torch.data.graphs.PartitionContainer`) whose cuts pin
    the plan.  Runs the resident translator's IR lowering and pass
    pipeline, then builds the streamed executable.  The lane kernels take
    int32/float32 values with a menu gather or a weight-free gather
    outside the menu (its message table computed a superstep); any other
    program takes the general partial (see the module docstring).
    """
    t0 = time.perf_counter()
    V = int(source.num_vertices)
    E = int(source.num_edges)
    ctx = PassContext(schedule=schedule, plan=splan,
                      use_kernels=device.type == "cuda",
                      num_vertices=V, num_edges=E)
    ir, pipeline_report = default_pipeline().run(
        lower_program(program), ctx, dump=dump_passes)
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
    dtype = ir.value_dtype
    table_gather = None
    general = dtype not in (torch.int32, torch.float32)
    if fused.gather.module is None and not general:
        facts = ir.facts if ir.facts is not None else analyze_program(
            program)
        if facts.weight_use.value is False:
            table_gather = fused.gather.fn
        else:
            general = True
    push_op = ir.find(PushScatterOp)
    policy = splan.direction
    push_legal = push_op is not None and policy.mode != "pull"

    out_deg = G._np(source.out_degrees).astype(np.int64)
    if hasattr(source, "partition_coo"):          # a container pins its cuts
        cuts = np.asarray(source.cuts, np.int64)
    else:
        cuts = G.edge_interval_cuts(out_deg, splan.num_partitions)
    store = preprocess.PartitionStore(
        source, cuts, width=schedule.push_ell_width,
        max_bytes=splan.partition_budget_bytes,
        pin=device.type == "cuda")
    build_s = 0.0
    if device.type == "cuda":
        from ..kernels import _build
        t_build0 = time.perf_counter()
        for name in ("edge_block", "push_ell", "segment_sum"):
            _build.library(name)
        build_s = time.perf_counter() - t_build0

    tt = time.perf_counter() - t0
    report = report_cls(
        program=program.name,
        backend=ir.backend,
        gather_module=fused.gather.module,
        reduce_module=fused.reduce.op,
        pipelines=splan.num_chunks,
        pes=1,
        device=str(device),
        translate_time_s=tt,
        est_flops_per_superstep=2.0 * E,
        est_bytes_per_superstep=float(E * (4 + 4 + dtype.itemsize)),
        est_collective_bytes=0,
        diagnostics=tuple(ctx.diagnostics),
        pass_report=(render_table(ctx.diagnostics, title="-- diagnostics --")
                     + "\n\n" + pipeline_report.render())
        if dump_passes else None,
        ir_dump=ir.dump(),
        direction_policy=policy.describe(),
        directions=("pull", "push") if push_legal else ("pull",),
        translate_breakdown={
            "passes_s": tt - build_s, "build_s": build_s, "total_s": tt,
            "analysis_s": next(
                (r.time_s for r in pipeline_report.records
                 if r.name == "program-analysis"), 0.0)},
        pull_sweep="dense",
        num_partitions=store.partitions,
        partition_budget_bytes=splan.partition_budget_bytes,
    )
    max_iters = schedule.superstep_budget(program.max_iters, V)
    return PartitionedGraphProgram(
        program, store, report, max_iters, device=device, ir=ir,
        fstep=fstep, fused=fused, apply_op=apply_op,
        frontier_op=frontier_op, push_legal=push_legal, splan=splan,
        comm=comm, out_degrees=out_deg, table_gather=table_gather,
        general=general,
        probe_divergence=schedule.probe_divergence,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        fingerprints_fn=lambda: ckpt.run_fingerprints(program, source,
                                                      schedule))
