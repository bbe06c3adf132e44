"""Light-weight translator (paper §V): DSL program × schedule → executable.

Counterpart of ``repro.core.translator`` for a resident graph on one
device, the dense backend, and the pull, push and auto directions:

1. :func:`~repro_torch.core.ir.lower_program` lowers the program to IR;
2. :func:`~repro_torch.core.passes.default_pipeline` runs the eight
   passes;
3. :func:`translate` walks the optimized IR and emits the supersteps:
   the dense pull sweep over the flat width-8 view
   (:func:`_emit_dense_pull_reduce`) and, when push is legal and wanted,
   the frontier-compacted forward-ELL push superstep
   (:func:`_emit_push_ell`).

The hand-written CUDA kernels are on exactly when the run's device is
CUDA (the JAX package turns Pallas on exactly on a TPU): the pull sweep
goes through ``kernels/edge_block.py``'s kernel and the push message stage
through ``kernels/push_ell.py``'s.  On the CPU both take their plain
PyTorch forms, so the tests hold the port against the JAX package there.

Algorithm 1's loop (:meth:`CompiledGraphProgram.run`) is a host loop: the
JAX package stages it as ``lax.while_loop`` with a ``lax.cond`` direction
switch and a ``lax.switch`` tier choice.  Here each superstep reads four
device counters in one transfer — any-active, the frontier's out-edges
``m_f``, its vertex count ``n_f`` and its live forward-ELL rows ``r_f`` —
and branches on the host: one device→host sync per superstep.  The
direction choice is computed in float32 exactly as the staged loop
computes it, and the counters are Python integers, so ``run_stats`` equal
the JAX package's.

Not ported yet, and refused with ``NotImplementedError``: the sparse
backend and the ``coo_chunks`` push (``ROADMAP.md`` §1 item 5.5), the
block-skipping pull plane (item 5.4), batched lanes (item 6), checkpoints
(item 7), several PEs (item 10) and streamed partitions (item 8).
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
from .scheduler import (DirectionPolicy, ScheduleConfig, plan,
                        push_capacity_tiers)

__all__ = ["classify_gather", "TranslationReport", "CompiledGraphProgram",
           "translate"]


@dataclasses.dataclass
class TranslationReport:
    program: str
    backend: str                  # 'dense_cuda' | 'dense_torch'
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
    push_layout: str | None = None   # 'fwd_ell' when push was emitted
    push_tiers: tuple | None = None  # compaction row capacities
    pull_sweep: str = "dense"
    est_frontier_bytes: int = 0


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
        self._pull_step = pull_step          # (values, active) → (new, nxt)
        self._push_step = push_step          # → (new, nxt, r_f) | None
        self._init_state = init_state
        self._direction = direction
        self._mode = direction.mode if push_step is not None else "pull"
        self._out_degrees = out_degrees
        self._rows_per_vertex = rows_per_vertex
        self._push_tiers = push_tiers
        self._num_vertices = num_vertices
        self._num_edges = num_edges
        self._probe = bool(probe_divergence)
        self.report = report
        self.max_iters = max_iters
        self.last_run_stats: dict | None = None

    def init_state(self, roots=None, values=None):
        """``(values, active)`` on the run's device; ``values`` may be a
        numpy array or a tensor."""
        return self._init_state(roots=roots, values=values)

    def superstep(self, values, active):
        """One pull-direction superstep (the canonical form)."""
        return self._pull_step(values, active)

    def superstep_push(self, values, active):
        """One push-direction superstep."""
        if self._push_step is None:
            raise ValueError("program was translated pull-only "
                             f"({self.report.direction_policy})")
        new, nxt, _ = self._push_step(values, active)
        return new, nxt

    def _occupancy(self, active) -> tuple[int, int, int]:
        """``(m_f, n_f, r_f)`` in one device→host transfer: the frontier's
        out-edges, its vertices (``n_f > 0`` is the loop condition) and
        its live forward-ELL rows (0 on a pull-only program)."""
        parts = [torch.where(active, self._out_degrees, 0).sum(
                     dtype=torch.int64),
                 active.sum(dtype=torch.int64)]
        if self._mode != "pull":
            parts.append(torch.where(active, self._rows_per_vertex, 0)
                         .sum(dtype=torch.int64))
        host = torch.stack(parts).tolist()
        return host[0], host[1], host[2] if len(host) > 2 else 0

    def _choose(self, prev_dir: int, m_f: int, n_f: int) -> int:
        """The direction register's next value (0 pull, 1 push).

        In float32, as the JAX package's staged loop computes it: past
        2^24 out-edges the rounding decides ties.  The pull cost it
        compares against is E: the dense plane sweeps every edge (the
        JAX package's measured-cost register only moves on the
        block-skipping plane).
        """
        if self._mode == "pull":
            return 0
        if self._mode == "push":
            return 1
        pol = self._direction
        if prev_dir == 1:
            return int(np.float32(m_f) * np.float32(pol.alpha)
                       < np.float32(self._num_edges))
        return int(np.float32(n_f) * np.float32(pol.beta)
                   < np.float32(self._num_vertices))

    def run(self, roots=None, values=None, *, checkpoint_dir=None):
        """Paper Algorithm 1's while-loop, on the host.

        Per-run direction stats land on ``self.last_run_stats`` and
        ``report.run_stats``, with the JAX package's keys: push/pull
        superstep counts, the compacted/fallback split of push supersteps,
        direction switches, ``edges_traversed`` (``m_f`` per push
        superstep, E per pull superstep), the pull-cost register and how
        the run ended.
        """
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpointed runs are not ported yet (ROADMAP.md §1 item 7)")
        values, active = self.init_state(roots=roots, values=values)
        E = self._num_edges
        tiers = self._push_tiers
        it = direction = pushes = compact = switches = 0
        push_edges = pull_edges = live_rows = 0
        probe = self._probe and values.dtype.is_floating_point
        while it < self.max_iters:
            m_f, n_f, r_f = self._occupancy(active)
            live = n_f > 0
            if not live:
                break
            new_dir = self._choose(direction, m_f, n_f)
            if new_dir:
                values, active, _ = self._push_step(values, active, r_f)
                pushes += 1
                compact += int(r_f <= tiers[-1])
                live_rows += r_f
                push_edges += m_f
            else:
                values, active = self._pull_step(values, active)
                pull_edges += E
            if probe:
                # a NaN anywhere freezes the frontier: the loop exits next
                # superstep and the run reads terminated='diverged'
                active = active & ~torch.isnan(values).any()
            switches += int(new_dir != direction)
            direction = new_dir
            it += 1
        else:
            live = bool(active.any())
        nanfree = not (probe and bool(torch.isnan(values).any()))
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
            "pull_blocks_swept": 0,
            "pull_blocks_skipped": 0,
            "pull_cost_model": E,
            "exchange_supersteps": 0,
            "exchange_bytes": 0,
            "terminated": terminated,
        }
        self.last_run_stats = stats
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

    ``partial_reduce(values, active, need_got)`` returns the per-vertex
    ``(red, got)`` tables (``got`` is ``None`` unless asked for: eager
    PyTorch has no dead-code elimination to drop the unused any-chain).

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
    if fused.kernel != "edge_block":
        raise NotImplementedError(
            f"backend {ir.backend!r}: the sparse segment-scan backend is not "
            "ported yet (ROADMAP.md §1 item 5.5)")
    pull_sweep = fstep.pull_sweep if fstep is not None else "dense"
    if pull_sweep == "bitmap":
        raise NotImplementedError(
            "pull_sweep='bitmap': the block-skipping pull plane is not "
            "ported yet (ROADMAP.md §1 item 5.4, §2 item 2)")
    policy = splan.direction
    push_op = ir.find(PushScatterOp) if policy.mode != "pull" else None
    if push_op is not None and push_op.layout != "fwd_ell":
        raise NotImplementedError(
            f"push layout {push_op.layout!r}: the chunk-streamed push scatter "
            "is not ported yet (ROADMAP.md §1 item 5.5)")

    # ---- stage 3: layouts, kernels, supersteps --------------------------
    t_emit0 = time.perf_counter()
    dtype = ir.value_dtype
    V = g.num_vertices
    lay = preprocess.layouts_for(g)
    pre_before = sum(lay.build_times_s.values())
    host_pplan = lay.pull_plan(schedule.pull_block_slots)
    host_fe = lay.forward_ell(schedule.push_ell_width) \
        if push_op is not None else None
    preprocess_s = sum(lay.build_times_s.values()) - pre_before
    t_move0 = time.perf_counter()
    pplan = lay.on(host_pplan, device)
    fe = lay.on(host_fe, device) if host_fe is not None else None
    out_deg = g.out_degrees.to(device=device, dtype=torch.int32)
    transfer_s = time.perf_counter() - t_move0
    build_s = 0.0
    if use_kernels:
        from ..kernels import _build
        t_build0 = time.perf_counter()
        _build.library("edge_block")
        if push_op is not None:
            _build.library("push_ell")
        build_s = time.perf_counter() - t_build0

    reduce_module = _emit_dense_pull_reduce(ir, fused, pplan, out_deg,
                                            use_kernels)
    apply_fn = apply_op.fn
    frontier_dead = frontier_op.dead
    changed = frontier_op.mode == "changed"
    touched_free = fstep.touched_free if fstep is not None else False
    need_got = changed and not touched_free

    def pull_step(values, active):
        red, got = reduce_module(values, active, need_got=need_got)
        new = apply_fn(values, red)
        if frontier_dead:
            # frontier='all': every vertex stays active, no change mask
            return new, torch.ones_like(active)
        if touched_free and changed:
            # identity-fixpoint apply: untouched vertices hold the reduce
            # identity, which the apply fixes, so no touched mask
            return new, new != values
        if changed:
            new = torch.where(got, new, values)
            return new, new != values
        return new, torch.ones_like(active)

    push_step = None
    push_tiers = None
    if push_op is not None:
        push_step, push_tiers = _emit_push_ell(
            ir, push_op, fe, out_deg, apply_fn, reduce_module, use_kernels)

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
        est_flops_per_superstep=2.0 * g.num_edges,
        est_bytes_per_superstep=float(g.num_edges * (4 + 4 + dtype.itemsize)),
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
        push_layout=push_op.layout if push_op is not None else None,
        push_tiers=push_tiers,
        pull_sweep=pull_sweep,
    )
    return CompiledGraphProgram(
        pull_step, push_step, init_state, report,
        schedule.superstep_budget(program.max_iters, V),
        direction=policy, out_degrees=out_deg,
        rows_per_vertex=fe.rows_per_vertex if fe is not None else None,
        push_tiers=push_tiers, num_vertices=V, num_edges=g.num_edges,
        probe_divergence=schedule.probe_divergence)
