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

Not ported yet, and refused with ``NotImplementedError``: batched lanes
(``ROADMAP.md`` §1 item 6), checkpoints (item 7), several PEs (item 10)
and streamed partitions (item 8).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..errors import DiagnosticError
from ..kernels import edge_block as edge_block_kernel
from ..kernels import pull_bitmap as pull_bitmap_kernel
from ..kernels import push_ell as push_ell_kernel
from ..kernels import push_scatter as push_scatter_kernel
from ..kernels.ref import row_reduce
from . import graph as G
from . import preprocess
from .analysis import analyze_program
from .comm import CommManager, resolve_device
from .diagnostics import max_severity, render_table
from .dsl import VertexProgram
from .ir import (ApplyOp, FrontierUpdateOp, FusedGatherReduceOp,
                 FusedSuperstepOp, PushScatterOp, SuperstepIR, lower_program)
from .passes import PassContext, classify_gather, default_pipeline
from .scheduler import (DirectionPolicy, ScheduleConfig, SchedulePlan, plan,
                        pull_block_capacities, push_capacity_tiers)

__all__ = ["classify_gather", "TranslationReport", "CompiledGraphProgram",
           "translate"]


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
                 probe_divergence: bool = False):
        # (values, active, m_f) → (new, nxt, (swept_edges, blocks_swept,
        # blocks_skipped)); each counter a Python int or a 0-d tensor
        self._pull_step = pull_step
        self._push_step = push_step          # → (new, nxt, r_f) | None
        self._init_state = init_state
        self._direction = direction
        self._mode = direction.mode if push_step is not None else "pull"
        self._out_degrees = out_degrees
        self._rows_per_vertex = rows_per_vertex   # None: no forward ELL
        self._push_tiers = push_tiers
        self._num_vertices = num_vertices
        self._num_edges = num_edges
        self._probe = bool(probe_divergence)
        self.report = report
        self.max_iters = max_iters
        self.last_run_stats: dict | None = None
        self.last_run_syncs: int | None = None

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

    def _occupancy(self, active, pull_stats=()):
        """``(m_f, n_f, r_f, pull_stats)`` in one device→host transfer.

        ``m_f`` is the frontier's out-edges, ``n_f`` its vertices
        (``n_f > 0`` is the loop condition), ``r_f`` its live forward-ELL
        rows (0 without a forward-ELL push twin); ``pull_stats`` comes
        back as Python ints, its tensors read in the same transfer.
        """
        parts = [torch.where(active, self._out_degrees, 0).sum(
                     dtype=torch.int64),
                 active.sum(dtype=torch.int64)]
        if self._mode != "pull" and self._rows_per_vertex is not None:
            parts.append(torch.where(active, self._rows_per_vertex, 0)
                         .sum(dtype=torch.int64))
        n = len(parts)
        parts += [s.reshape(()).to(torch.int64) for s in pull_stats
                  if isinstance(s, torch.Tensor)]
        host = torch.stack(parts).tolist()
        rest = iter(host[n:])
        stats = tuple(next(rest) if isinstance(s, torch.Tensor) else int(s)
                      for s in pull_stats)
        return host[0], host[1], host[2] if n > 2 else 0, stats

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

    def run(self, roots=None, values=None, *, checkpoint_dir=None):
        """Paper Algorithm 1's while-loop, on the host.

        Per-run direction stats land on ``self.last_run_stats`` and
        ``report.run_stats``, with the JAX package's keys: push/pull
        superstep counts, the compacted/fallback split of push supersteps,
        direction switches, ``edges_traversed`` (``m_f`` per push
        superstep, the swept edges per pull superstep: E on a dense
        sweep), the bitmap plane's swept/skipped blocks, the final
        measured pull-cost register and how the run ended.  The number of
        device→host reads the run made is ``self.last_run_syncs``.
        """
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpointed runs are not ported yet (ROADMAP.md §1 item 7)")
        values, active = self.init_state(roots=roots, values=values)
        tiers = self._push_tiers
        it = direction = pushes = compact = switches = syncs = 0
        push_edges = pull_edges = live_rows = swept = skipped = 0
        pull_cost = self._num_edges
        pending = ()     # the last pull superstep's counters, read next
        probe = self._probe and values.dtype.is_floating_point
        while True:
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
                values, active, _ = self._push_step(values, active, r_f)
                pushes += 1
                # a coo_chunks push has no dense fallback: it counts as
                # compacted, as in the JAX package
                compact += int(tiers is None or r_f <= tiers[-1])
                live_rows += r_f
                push_edges += m_f
            else:
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
        if not nanfree:
            terminated = "diverged"
        elif live and it >= self.max_iters:
            terminated = "budget"
        else:
            terminated = "converged"
        stats = {
            "push_supersteps": pushes,
            "push_compacted_supersteps": compact,
            "push_fallback_supersteps": pushes - compact,
            "pull_supersteps": it - pushes,
            "direction_switches": switches,
            "edges_traversed": pull_edges + push_edges,
            "pes": 1,
            "push_live_rows_per_pe": [live_rows],
            "pull_blocks_swept": swept,
            "pull_blocks_skipped": skipped,
            "pull_cost_model": pull_cost,
            "exchange_supersteps": 0,
            "exchange_bytes": 0,
            "terminated": terminated,
        }
        self.last_run_stats = stats
        self.last_run_syncs = syncs
        self.report.run_stats = stats
        return values, it

    def run_batch(self, roots):
        raise NotImplementedError(
            "batched runs and the lane API are not ported yet "
            "(ROADMAP.md §1 item 6)")


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
            return row_reduce(op, msg, 1), torch.any(live, dim=1)
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
        return row_reduce(op, msg, 1), sub_any

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
    ``mask_inactive``).  Chunks are slices of the flat arrays, so no
    padded copy is kept.  ``partial_reduce(values, active, need_got)``
    returns ``(red, got)``.
    """
    program = ir.program
    ident = fused.reduce.identity.item()
    seg_dst, src, wts = reverse_coo
    starts = range(0, min(num_edges, splan.num_chunks * splan.chunk_size),
                   splan.chunk_size)
    chunks = [[a[s:s + splan.chunk_size] for s in starts]
              for a in (seg_dst, src, wts)]

    def partial_reduce(values, active, need_got=True):
        if not program.mask_inactive:
            active = torch.ones_like(active)
        return push_scatter_kernel.push_scatter_reduce(
            *chunks, values, out_deg, active, gather_fn=fused.gather.fn,
            reduce=fused.reduce.op, identity=ident, num_vertices=num_vertices,
            dtype=ir.value_dtype, emit_touched=need_got)

    return partial_reduce


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


def _emit_push_ell(ir: SuperstepIR, push_op: PushScatterOp,
                   fe: G.ForwardELL, out_deg, apply_fn, pull_reduce_module,
                   use_kernels: bool):
    """The frontier-compacted forward-ELL push superstep.

    The live row count ``r_f`` picks the smallest capacity tier that
    covers the frontier, or the dense fallback (the pull module's masked
    sweep) when it is wider than the largest tier; all branches compute
    the same superstep.  The compacted branches apply the reduced table
    everywhere and skip the touched mask: the fusion pass binds this
    layout only for an identity-fixpoint apply.  Returns
    ``(push_superstep, tiers)``; the superstep maps ``(values, active,
    r_f)`` to ``(new, next_active, r_f)``, with ``r_f`` computed here when
    the caller passes ``None``.
    """
    dtype = ir.value_dtype
    V = fe.num_vertices
    ident = push_op.reduce.identity.item()
    tiers = push_capacity_tiers(fe.num_rows)
    rows_per_v = fe.rows_per_vertex

    def compacted(capacity, values, active):
        red, _ = push_ell_kernel.push_ell_reduce(
            fe.row_src, fe.dst, fe.weights, values, out_deg, active,
            num_rows=fe.num_rows, capacity=capacity,
            gather_fn=push_op.gather.fn, reduce=push_op.reduce.op,
            identity=ident, num_vertices=V, dtype=dtype,
            gather_module=push_op.gather.module, use_kernels=use_kernels)
        return red

    def push_superstep(values, active, r_f=None):
        if r_f is None:
            r_f = int(torch.where(active, rows_per_v, 0).sum())
        tier = sum(int(r_f > c) for c in tiers)
        if tier < len(tiers):
            red = compacted(tiers[tier], values, active)
        else:
            red, _ = pull_reduce_module(values, active, need_got=False)
        new = apply_fn(values, red)
        return new, new != values, r_f

    return push_superstep, tiers


# ---------------------------------------------------------------------------
# The translator
# ---------------------------------------------------------------------------


def translate(
    program: VertexProgram,
    g: G.Graph,
    schedule: ScheduleConfig | None = None,
    comm: CommManager | None = None,
    *,
    device=None,
    dump_passes: bool = False,
    validate: bool = False,
    strict: bool = False,
    checkpoint_dir: str | None = None,
) -> CompiledGraphProgram:
    """Stage a DSL program into an executable for graph ``g`` on ``device``.

    ``device=None`` means the CUDA device and raises when there is none;
    the CUDA kernels are on exactly when the device is CUDA.  Layouts are
    built on the host once per graph (:func:`repro_torch.core.preprocess.
    layouts_for`) and copied to the device once per device.
    ``strict=True`` refuses a program carrying a warning- or error-severity
    diagnostic.
    """
    t0 = time.perf_counter()
    device = resolve_device(device)
    use_kernels = device.type == "cuda"
    schedule = schedule or ScheduleConfig()
    comm = comm or CommManager()
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpointed runs are not ported yet (ROADMAP.md §1 item 7)")
    if not isinstance(g, G.Graph):
        raise NotImplementedError(
            "streamed partition containers are not ported yet "
            "(ROADMAP.md §1 item 8)")
    if validate:
        G.validate_graph(g, reduce=program.reduce)
    splan = plan(schedule, num_vertices=g.num_vertices,
                 num_edges=g.num_edges)

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
    preprocess_s = sum(lay.build_times_s.values()) - pre_before
    t_move0 = time.perf_counter()
    on = {k: lay.on(v, device) for k, v in host.items()}
    out_deg = g.out_degrees.to(device=device, dtype=torch.int32)
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
    if dense:
        reduce_module, sub_sweep = _emit_dense_pull_reduce(
            ir, fused, on["pplan"], out_deg, use_kernels)
    else:
        reduce_module = _emit_segment_scan_reduce(
            ir, fused, on["rcoo"], V, E, out_deg, splan)
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
    push_step = push_tiers = rows_per_vertex = None
    if push_layout == "fwd_ell":
        push_step, push_tiers = _emit_push_ell(
            ir, push_op, on["fe"], out_deg, apply_fn, reduce_module,
            use_kernels)
        rows_per_vertex = on["fe"].rows_per_vertex
    elif push_layout == "coo_chunks":
        scatter_step = make_superstep(_emit_push_scatter(
            ir, push_op, on["fchunks"], out_deg, V))

        def push_step(values, active, r_f=None):
            return (*scatter_step(values, active), 0)

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
    report = TranslationReport(
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
        est_collective_bytes=comm.estimate_collective_bytes(V, dtype, 1),
        est_frontier_bytes=comm.estimate_frontier_bytes(V, 1),
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
    )
    return CompiledGraphProgram(
        pull_step, push_step, init_state, report,
        schedule.superstep_budget(program.max_iters, V),
        direction=policy, out_degrees=out_deg,
        rows_per_vertex=rows_per_vertex, push_tiers=push_tiers,
        num_vertices=V, num_edges=E,
        probe_divergence=schedule.probe_divergence)
