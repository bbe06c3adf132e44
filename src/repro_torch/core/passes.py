"""Analysis/transform passes over the superstep IR (paper §V).

Counterpart of ``repro.core.passes``: the same eight passes in the same
order (:func:`default_pipeline`).  What differs:

* the backend flavors are ``'dense_cuda'`` (kernels on, the run's device
  is CUDA), ``'dense_torch'`` and ``'sparse_torch'``;
* every fact comes from the static analyzer over traced ATen graphs
  (:mod:`repro_torch.core.analysis`; sampling probes only for an
  untraceable callable);
* ``pull_sweep='auto'`` resolves dense on both flavors: on
  ``'dense_torch'`` as the JAX package's XLA path does, on
  ``'dense_cuda'`` by the H100 walls in :data:`CUDA_AUTO_SWEEP_NOTE`
  (the JAX package picks the bitmap plane under Pallas unmeasured);
* the resolved PE count (``SchedulePlan.pes``, a device list's length)
  decides the multi-PE legality rules and the exchange op, as the JAX
  package's mesh size does.
"""
from __future__ import annotations

import dataclasses
import os
import time

from ..errors import IRVerificationError
from .analysis import (analyze_program, apply_is_elementwise,
                       apply_preserves_identity, classify_gather,
                       gather_absorbs_identity, verify_ir)
from .comm import REDUCE_COLLECTIVE
from .diagnostics import Diagnostic
from .dsl import reduce_identity
from .ir import (ApplyOp, ExchangeOp, FrontierUpdateOp, FusedGatherReduceOp,
                 FusedSuperstepOp, GatherOp, PushScatterOp, ReduceOp,
                 SuperstepIR)
from .scheduler import ScheduleConfig, SchedulePlan

__all__ = [
    "classify_gather",
    "apply_preserves_identity",
    "apply_is_elementwise",
    "gather_absorbs_identity",
    "verify_ir",
    "PassContext",
    "Pass",
    "PassRecord",
    "PipelineReport",
    "PassPipeline",
    "ProgramAnalysisPass",
    "GatherClassificationPass",
    "DirectionLegalityPass",
    "ReduceIdentityFoldPass",
    "BackendSelectionPass",
    "GatherReduceFusionPass",
    "DeadFrontierEliminationPass",
    "SuperstepFusionPass",
    "default_pipeline",
]

# Reduce ops that commute and have a two-sided identity — the algebraic
# requirement for reordering per-edge contributions in push mode.
COMMUTATIVE_REDUCES = ("add", "min", "max")

# Why pull_sweep='auto' resolves dense on the CUDA path as well:
# chip_smoke.py's steady BFS run walls at Graph500 scale 22 (root 0,
# median of 3), where the bitmap plane was slower under direction='pull'
# (its touched pre-pass and block flags cost more than kernel 2 saves on
# the two narrow supersteps) and level under 'auto' (PERF.md section 6).
# The plane would be chosen only if it were no slower under both.
CUDA_AUTO_SWEEP_NOTE = (
    "scale-22 BFS walls on NVIDIA H100 80GB HBM3, 700.00 W (pull: dense "
    "5.973 ms, bitmap 7.062 ms; auto: dense 11.732 ms, bitmap 11.727 ms; "
    "chip_smoke.py)")


# ---------------------------------------------------------------------------
# Pipeline machinery
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PassContext:
    """Read-only facts every pass may consult.

    Carries the graph shape, the scheduler's resolved
    :class:`~repro_torch.core.scheduler.SchedulePlan`, and whether the
    hand-written kernels are on (the run's device is CUDA) — the pass
    pipeline never touches graph *data*, only metadata.

    ``diagnostics`` is the one mutable slot: the typed
    :class:`~repro_torch.core.diagnostics.Diagnostic` accumulator passes append
    to (the analysis pass's lint findings, the verifier's ``V*`` codes),
    surfaced as ``TranslationReport.diagnostics``.
    """

    schedule: ScheduleConfig
    plan: SchedulePlan
    use_kernels: bool
    num_vertices: int
    num_edges: int
    diagnostics: list = dataclasses.field(default_factory=list,
                                          compare=False)

    def diagnose(self, diag: Diagnostic) -> None:
        """Append one structured finding to this translation's accumulator."""
        self.diagnostics.append(diag)


class Pass:
    """Base class for IR passes.

    Subclasses set ``name`` and ``kind`` (``'analysis'`` records facts
    without changing computation; ``'transform'`` rewrites the IR) and
    implement :meth:`run` returning a new :class:`SuperstepIR` — passes are
    functional, the input IR is never mutated.
    """

    name: str = "pass"
    kind: str = "transform"

    def run(self, ir: SuperstepIR, ctx: PassContext) -> SuperstepIR:
        """Rewrite (or merely annotate) ``ir``; must preserve numerics."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PassRecord:
    """One pipeline step's observable outcome: dumps before and after."""

    name: str
    kind: str
    changed: bool
    before: str | None = None
    after: str | None = None
    time_s: float = 0.0

    def render(self) -> str:
        """Readable report section for this pass."""
        head = f"== {self.name} [{self.kind}] " \
               f"{'(changed)' if self.changed else '(no change)'}"
        if self.before is None:
            return head
        body = [head, "-- before --", self.before, "-- after --",
                self.after or ""]
        return "\n".join(body)


@dataclasses.dataclass(frozen=True)
class PipelineReport:
    """All :class:`PassRecord`\\ s of one :meth:`PassPipeline.run`."""

    records: tuple

    def render(self) -> str:
        """The full per-pass before/after report (the "TT"-style dump)."""
        return "\n\n".join(r.render() for r in self.records)


class PassPipeline:
    """Ordered pass runner with per-pass before/after dump recording."""

    def __init__(self, passes: list[Pass]):
        self.passes = list(passes)

    def run(self, ir: SuperstepIR, ctx: PassContext, dump: bool = False,
            verify: bool | None = None) -> tuple[SuperstepIR, PipelineReport]:
        """Run every pass in order; returns (optimized IR, report).

        With ``dump=True`` each record carries the full textual IR before
        and after the pass; without it only names and changed-flags are
        recorded (cheap enough to keep on every translation).

        With ``verify=True`` the structural IR verifier
        (:func:`repro_torch.core.analysis.verify_ir`) runs on the input IR and
        again after *every* pass, raising
        :class:`~repro_torch.errors.IRVerificationError` at the first offending
        pass boundary with the typed ``V*`` diagnostics naming each broken
        invariant.  ``verify=None`` (the default) reads the
        ``REPRO_VERIFY_IR`` environment variable — set to ``1`` by
        ``tests/conftest.py`` and CI so every tier-1 translation crosses
        the verifier, and unset in production where the ~50 µs/pass cost
        is pure overhead on a well-formed pipeline.
        """
        if verify is None:
            verify = os.environ.get("REPRO_VERIFY_IR", "") == "1"
        records = []
        if verify:
            self._verify(ir, ctx, "before first pass")
        for p in self.passes:
            before = ir.dump() if dump else None
            t0 = time.perf_counter()
            out = p.run(ir, ctx)
            dt = time.perf_counter() - t0
            records.append(PassRecord(
                name=p.name, kind=p.kind, changed=out is not ir,
                before=before, after=out.dump() if dump else None,
                time_s=dt))
            ir = out
            if verify:
                self._verify(ir, ctx, f"after {p.name}")
        return ir, PipelineReport(records=tuple(records))

    @staticmethod
    def _verify(ir: SuperstepIR, ctx: PassContext, stage: str) -> None:
        """Raise :class:`IRVerificationError` if ``ir`` breaks an invariant."""
        violations = verify_ir(ir, ctx)
        if violations:
            for d in violations:
                ctx.diagnose(d)
            codes = ", ".join(
                f"{d.code} ({d.message})" for d in violations)
            raise IRVerificationError(
                f"IR verification failed {stage}: {codes}",
                stage=stage, diagnostics=tuple(violations))


# ---------------------------------------------------------------------------
# Concrete passes
# ---------------------------------------------------------------------------


def _facts(ir: SuperstepIR):
    """The IR's analysis facts, recomputing (cached) when a pass is driven
    standalone in tests without :class:`ProgramAnalysisPass` first."""
    return ir.facts if ir.facts is not None else analyze_program(ir.program)


def _general_table_dense(ir: SuperstepIR, ctx: PassContext,
                         module: str | None) -> bool:
    """Unmatched gather that still runs the dense table sweep.

    A weight-free gather's message depends only on its source, so the
    dense flat sweep can precompute the one-gather-per-slot message table
    from the *user's own callable* (``message_table(gather=None,
    gather_fn=...)``) — no menu match needed.  Restricted to the plain
    PyTorch path: the CUDA edge-block kernel evaluates menu modules only.
    """
    return (module is None and not ctx.use_kernels
            and _facts(ir).weight_use.value is False)


class ProgramAnalysisPass(Pass):
    """Run the program analyzer and attach its facts (analysis).

    Calls :func:`repro_torch.core.analysis.analyze_program` (cached per
    program object) and stores the result on ``SuperstepIR.facts`` so
    every downstream pass decides from the same analysis.  The analyzer's
    program-level diagnostics and the ``A005`` mask/frontier lint rule
    land on ``PassContext.diagnostics`` here.
    """

    name = "program-analysis"
    kind = "analysis"

    def run(self, ir: SuperstepIR, ctx: PassContext) -> SuperstepIR:
        """Attach :class:`~repro_torch.core.analysis.ProgramAnalysis` to the IR."""
        if ir.facts is not None:
            return ir
        facts = analyze_program(ir.program)
        for d in facts.diagnostics:
            ctx.diagnose(d)
        program = ir.program
        if program.frontier == "changed" and not program.mask_inactive:
            ctx.diagnose(Diagnostic(
                "A005", "warning", "FrontierUpdate",
                "mask_inactive=False with frontier='changed': sources the "
                "frontier calls settled keep contributing messages, so "
                "convergence depends on those stale contributions being "
                "harmless",
                "set mask_inactive=True, or frontier='all' if every "
                "vertex should stay live"))
        # keyed on the requested pes, not the plan's device-clamped one:
        # the rule flags the deployment intent, which a host with fewer
        # devices would otherwise mask by degrading to one PE
        if program.reduce == "add" and ir.value_dtype.is_floating_point \
                and getattr(ctx.schedule, "pes", 1) > 1 \
                and getattr(ctx.schedule, "message_dtype", None) is not None:
            ctx.diagnose(Diagnostic(
                "A006", "warning", "Exchange",
                f"float 'add' reduce over a quantized "
                f"(message_dtype={ctx.schedule.message_dtype!r}) multi-PE "
                f"(pes={ctx.schedule.pes}) exchange: wire rounding "
                "compounds per superstep and per PE on hub-heavy graphs",
                "drop message_dtype (full-precision exchange) or use a "
                "min/max reduce"))
        summary = facts.summary()
        rendered = " ".join(f"{k}={v!r}" for k, (v, _) in summary.items())
        probed = [k for k, (_, prov) in summary.items() if prov != "static"]
        tail = f" (non-static: {', '.join(probed)})" if probed else ""
        return ir.replace(facts=facts).with_note(
            f"analysis: {rendered}{tail}")


class GatherClassificationPass(Pass):
    """Annotate the gather op with its matched pre-built module (analysis).

    Records the paper's module-matching result on
    :attr:`~repro_torch.core.ir.GatherOp.module` — decided by the
    gather graph's canonical signature against the menu's (a sampling
    probe only for an untraceable gather); an unmatched gather stays
    ``None`` and later takes the general sparse path (or the dense table
    sweep when weight-free).
    """

    name = "gather-classification"
    kind = "analysis"

    def run(self, ir: SuperstepIR, ctx: PassContext) -> SuperstepIR:
        """Annotate the gather op with the analyzer's module fact."""
        gop = ir.find(GatherOp)
        if gop is None or gop.module is not None:
            return ir
        module = _facts(ir).gather_module.value
        ir = ir.replace_op(gop, dataclasses.replace(gop, module=module))
        note = (f"gather matched module {module!r}" if module is not None
                else "gather unmatched -> general sparse path")
        return ir.with_note(note)


class DirectionLegalityPass(Pass):
    """Prove push-direction legality, or record why pull is pinned (analysis).

    Pull processes every in-edge each superstep; push scatters only along
    the frontier's out-edges.  The two are equivalent iff per-edge
    contributions may arrive in any order and non-frontier sources
    contribute nothing, i.e.:

    * the reduce is commutative/associative with an identity, *exactly*:
      ``min``/``max`` always, ``add`` only on integer dtypes (float add is
      order-sensitive, and push and pull visit edges in different orders);
    * ``mask_inactive=True`` — pull already drops messages from inactive
      sources, so skipping those sources entirely changes nothing;
    * ``frontier='changed'`` — a sparse frontier exists to push from
      (``'all'`` re-activates every vertex, push degenerates to pull).

    Under a multi-PE plan (``pes > 1``) push is additionally legal only on
    the compacted forward-ELL data path: the dense backend (after the
    unmatched-gather downgrade, which this pass anticipates) *and* an
    identity-fixpoint apply (``apply(x, identity) == x``, analyzed).  The
    sharded engine partitions the forward ELL into disjoint per-PE row
    intervals and combines the per-PE partial tables with the
    reduce-matched collective; the chunk-streamed ``coo_chunks`` push
    stays single-PE, so non-fixpoint applies pin to pull on multi-PE
    plans, with the reason noted in the IR.

    A legal program gets ``Gather.direction='both'``; a pinned program
    keeps ``'pull'`` and the reason lands in the IR notes (and thus the
    pass dump — ``translate(..., dump_passes=True)``).  Which push *data
    path* a legal program gets (compacted forward ELL vs chunk-streamed
    scatter) is the fusion pass's job, where the apply-identity-fixpoint
    fact gates the compacted engine.
    """

    name = "direction-legality"
    kind = "analysis"

    def run(self, ir: SuperstepIR, ctx: PassContext) -> SuperstepIR:
        """Widen ``Gather.direction`` to ``'both'`` or note the pull pin."""
        gop, rop = ir.find(GatherOp), ir.find(ReduceOp)
        if gop is None or rop is None or gop.direction != "pull":
            return ir
        program = ir.program
        pes = ctx.plan.pes
        reasons = []
        if rop.op not in COMMUTATIVE_REDUCES:
            reasons.append(f"reduce '{rop.op}' is not commutative-with-identity")
        elif rop.op == "add" and ir.value_dtype.is_floating_point:
            # min/max and integer add are order-insensitive; float add is
            # not, and the 'changed' frontier (new != values) would amplify
            # one-ulp push/pull differences into different frontier sets
            reasons.append("float 'add' reduce is order-sensitive (push and "
                           "pull sum edge contributions in different orders)")
        if not program.mask_inactive:
            reasons.append("mask_inactive=False needs messages from "
                           "inactive sources")
        if program.frontier != "changed":
            reasons.append(f"frontier='{program.frontier}' keeps every "
                           "vertex active (no sparse frontier to push from)")
        if pes > 1 and not reasons:
            # multi-PE push runs only on the sharded forward-ELL engine;
            # anticipate the backend-selection downgrade (an unmatched
            # gather forces sparse) so the note names the real reason
            dense = ctx.plan.backend == "dense" and gop.module is not None
            kept_dense = ctx.plan.backend == "dense" \
                and _general_table_dense(ir, ctx, gop.module)
            if not dense and not kept_dense:
                reasons.append(
                    f"multi-PE push (pes={pes}) needs the dense forward-ELL "
                    "engine; the sparse plan shards the pull plane instead")
            elif kept_dense:
                reasons.append(
                    f"multi-PE push (pes={pes}) needs a menu-matched gather "
                    "(the unmatched table sweep runs replicated)")
            elif not _facts(ir).identity_fixpoint.value:
                reasons.append(
                    f"multi-PE push (pes={pes}) needs an identity-fixpoint "
                    "apply (the touched-mask coo_chunks layout is single-PE)")
        if reasons:
            return ir.with_note("direction: pinned to pull ("
                                + "; ".join(reasons) + ")")
        ir = ir.replace_op(gop, dataclasses.replace(gop, direction="both"))
        if pes > 1:
            return ir.with_note(
                f"direction: push legal across pes={pes} (disjoint "
                "forward-ELL row intervals, reduce-matched collective)")
        return ir.with_note("direction: push legal (commutative reduce, "
                            "identity masking, sparse frontier)")


class ReduceIdentityFoldPass(Pass):
    """Constant-fold the reduce identity for the program dtype (transform).

    The folded constant is what the emitted kernels use to initialize
    accumulator tables and mask dead edge slots, so folding it once here
    keeps every backend consistent.
    """

    name = "reduce-identity-fold"
    kind = "transform"

    def run(self, ir: SuperstepIR, ctx: PassContext) -> SuperstepIR:
        """Fold ``reduce_identity(op, dtype)`` into the reduce op."""
        rop = ir.find(ReduceOp)
        if rop is None or rop.identity is not None:
            return ir
        ident = reduce_identity(rop.op, ir.value_dtype)
        return ir.replace_op(rop, dataclasses.replace(rop, identity=ident))


class BackendSelectionPass(Pass):
    """Resolve the concrete kernel flavor from the scheduler plan (transform).

    Consumes the :class:`~repro_torch.core.scheduler.SchedulePlan`:
    ``dense`` becomes the CUDA (kernels on) or plain PyTorch ELL
    edge-block module, ``sparse`` the segment-scan module.  An unmatched
    gather downgrades dense → sparse (only the sparse module has a
    general gather path).  The cross-PE
    :class:`~repro_torch.core.ir.ExchangeOp` is resolved to its
    reduce-matched collective whenever a plane will shard — the sparse
    pull plane, or the dense plan's sharded forward-ELL *push* plane (the
    direction-legality pass widened the gather to ``'both'``) — and
    deleted otherwise (one PE, or a dense pull-only plan, whose masked
    sweep runs replicated).
    """

    name = "backend-selection"
    kind = "transform"

    def run(self, ir: SuperstepIR, ctx: PassContext) -> SuperstepIR:
        """Set ``ir.backend`` and resolve or delete the exchange op."""
        backend = ctx.plan.backend
        gop = ir.find(GatherOp)
        fused = ir.find(FusedGatherReduceOp)
        module = gop.module if gop is not None else \
            (fused.gather.module if fused is not None else None)
        if module is None:
            if backend != "sparse" and _general_table_dense(ir, ctx, module):
                # the analyzer proved the gather weight-free: the dense
                # flat sweep precomputes its one-gather-per-slot message
                # table from the user callable, no menu match needed
                ir = ir.with_note(
                    "backend kept dense (unmatched weight-free gather -> "
                    "one-gather-per-slot table sweep)")
            else:
                if backend != "sparse":
                    ir = ir.with_note("backend downgraded dense -> sparse "
                                      "(unmatched gather)")
                backend = "sparse"
        if backend == "dense":
            flavor = "dense_cuda" if ctx.use_kernels else "dense_torch"
        else:
            flavor = "sparse_torch"
        ir = ir.replace(backend=flavor)

        xop = ir.find(ExchangeOp)
        if xop is not None:
            # the resolved PE count, not config.pes: the plan may have
            # degraded to fewer devices
            pes = ctx.plan.pes
            direction = gop.direction if gop is not None else "pull"
            push_plane = backend == "dense" and direction == "both"
            if pes <= 1 or (backend == "dense" and not push_plane):
                ir = ir.replace_op(xop, None)  # dead exchange: elide
            else:
                coll = REDUCE_COLLECTIVE[xop.reduce]
                ir = ir.replace_op(xop, dataclasses.replace(
                    xop, pes=pes, collective=coll))
                if push_plane:
                    ir = ir.with_note(
                        f"exchange: push plane (pes={pes}, {coll} over "
                        "disjoint forward-ELL intervals); pull sweep "
                        "stays replicated")
        return ir.with_note(f"schedule: {ctx.plan.describe()}")


class GatherReduceFusionPass(Pass):
    """Fuse the gather+reduce pair onto one edge-processing kernel (transform).

    Requires a resolved backend: dense flavors take the ELL
    ``'edge_block'`` kernel (CUDA on the card, plain PyTorch on the CPU),
    sparse takes the chunk-streamed ``'segment_scan'`` kernel.  The fused
    op keeps both the matched module name and the original callable, so
    the general path still has the user's gather to trace.

    When the direction-legality pass widened the gather to ``'both'``,
    the push-mode :class:`~repro_torch.core.ir.PushScatterOp` twin is inserted
    right after the fused pull op — the translator emits both supersteps
    and the runtime direction policy picks per superstep.  The twin's
    ``layout`` is bound here:

    * ``'fwd_ell'`` — the frontier-compacted forward-ELL engine — needs a
      dense backend *and* an identity-fixpoint apply
      (``apply(x, identity) == x``, analyzed like module matching): the
      compacted kernel applies the reduced table everywhere instead of
      scattering a touched mask, so untouched vertices must be fixpoints;
    * ``'coo_chunks'`` — the chunk-streamed forward-COO scatter —
      otherwise (the sparse backend builds no forward ELL, and a
      non-fixpoint apply needs the touched-mask form; the downgrade
      reason is recorded as an IR note).
    """

    name = "gather-reduce-fusion"
    kind = "transform"

    def run(self, ir: SuperstepIR, ctx: PassContext) -> SuperstepIR:
        """Replace Gather+Reduce with a :class:`FusedGatherReduceOp`."""
        gop, rop = ir.find(GatherOp), ir.find(ReduceOp)
        if gop is None or rop is None or ir.backend is None:
            return ir
        kernel = "edge_block" if ir.backend.startswith("dense") \
            else "segment_scan"
        fused = FusedGatherReduceOp(gather=gop, reduce=rop, kernel=kernel,
                                    direction=gop.direction)
        ir = ir.fuse(gop, rop, fused)
        if gop.direction == "both":
            layout = "fwd_ell"
            if not ir.backend.startswith("dense"):
                layout = "coo_chunks"
            elif not _facts(ir).identity_fixpoint.value:
                layout = "coo_chunks"
                ir = ir.with_note(
                    "push layout: coo_chunks (apply is not an identity "
                    "fixpoint, the compacted engine needs "
                    "apply(x, identity) == x)")
            ops = []
            for op in ir.ops:
                ops.append(op)
                if op is fused:
                    ops.append(PushScatterOp(gather=gop, reduce=rop,
                                             layout=layout))
            ir = ir.replace(ops=tuple(ops))
        return ir


class DeadFrontierEliminationPass(Pass):
    """Mark the frontier update dead for ``frontier='all'`` programs.

    Such programs activate every vertex each superstep, so the change mask
    (``new != values``) and the reduce's touched mask are never consumed —
    marking the op dead lets the translation stage skip emitting them
    at all.
    """

    name = "dead-frontier-elimination"
    kind = "transform"

    def run(self, ir: SuperstepIR, ctx: PassContext) -> SuperstepIR:
        """Set ``dead=True`` on the frontier op when the mode is ``'all'``."""
        fop = ir.find(FrontierUpdateOp)
        if fop is None or fop.dead or fop.mode != "all":
            return ir
        return ir.replace_op(fop, dataclasses.replace(fop, dead=True))


class SuperstepFusionPass(Pass):
    """Fuse ``FusedGatherReduce → Apply → FrontierUpdate`` into one stage
    (transform), and bind the pull plane's data path.

    When :func:`apply_is_elementwise` proves the apply elementwise, the
    triple collapses into a :class:`~repro_torch.core.ir.FusedSuperstepOp` so
    the translation stage emits one fused superstep — reduced values feed
    the apply and the change mask directly instead of round-tripping
    through full-table intermediates between separately-staged modules.
    A non-elementwise apply declines fusion with the reason as an IR note
    and keeps the three-op emission.

    Fusion is also where the **bitmap-frontier pull sweep** becomes
    available (only a fused stage can skip blocks: the skip decision
    needs the frontier, the apply, and the combine in one place).  The
    fused op's ``pull_sweep`` is bound ``'bitmap'`` iff:

    * the schedule does not pin ``pull_sweep='dense'``;
    * ``mask_inactive=True`` — a skipped block's sources are inactive, so
      under masking it contributes exactly the identity (bit-exact skip;
      without masking every block always contributes);
    * ``frontier='changed'`` — an ``'all'`` frontier keeps every block
      live, so the bitmap plane would add summary work and skip nothing;
    * the backend is dense (the skippable blocks are the reversed
      bucketed ELL's);
    * the graph has edges (an edgeless sweep has nothing to skip);
    * the schedule asks for it: ``pull_sweep='auto'`` resolves dense on
      the plain PyTorch path (as the JAX package's XLA path, whose flat
      sweep beats the skip bookkeeping) and on the CUDA path, where the
      note records the H100 walls of :data:`CUDA_AUTO_SWEEP_NOTE`.
    """

    name = "superstep-fusion"
    kind = "transform"

    def run(self, ir: SuperstepIR, ctx: PassContext) -> SuperstepIR:
        """Wrap the triple in a :class:`FusedSuperstepOp` when legal."""
        fused = ir.find(FusedGatherReduceOp)
        aop, fop = ir.find(ApplyOp), ir.find(FrontierUpdateOp)
        if fused is None or aop is None or fop is None \
                or ir.find(FusedSuperstepOp) is not None:
            return ir
        if not _facts(ir).elementwise.value:
            return ir.with_note(
                "superstep fusion declined (apply is not elementwise: "
                "output slots depend on more than their own inputs)")
        program = ir.program
        sweep = "bitmap"
        reasons = []
        if ctx.schedule.pull_sweep == "dense":
            reasons.append("schedule pins pull_sweep='dense'")
        elif ctx.schedule.pull_sweep == "auto" and not ctx.use_kernels:
            reasons.append("pull_sweep='auto' resolves dense on the plain "
                           "PyTorch path (as the JAX package's XLA path)")
        elif ctx.schedule.pull_sweep == "auto":
            reasons.append("pull_sweep='auto' resolves dense on the CUDA "
                           "path: the bitmap plane is not faster, "
                           + CUDA_AUTO_SWEEP_NOTE)
        if not program.mask_inactive:
            reasons.append("mask_inactive=False (every block contributes)")
        if program.frontier != "changed":
            reasons.append(f"frontier='{program.frontier}' keeps every "
                           "block live")
        if not (ir.backend or "").startswith("dense"):
            reasons.append("sparse backend has no blocked reversed ELL "
                           "(and its multi-PE plan shards the pull plane)")
        if ctx.num_edges == 0:
            reasons.append("edgeless graph")
        if reasons:
            sweep = "dense"
            ir = ir.with_note("pull sweep: dense (" + "; ".join(reasons)
                              + ")")
        else:
            ir = ir.with_note(
                "pull sweep: bitmap (block-skipping sweep over the "
                "reversed ELL; skip is bit-exact under identity masking)")
        # identity-fixpoint applies (min/max templates, integer add) let
        # the fused stage skip the touched-mask plane entirely: untouched
        # vertices hold the reduce identity, which the apply fixes
        touched_free = program.frontier == "changed" \
            and _facts(ir).identity_fixpoint.value
        if touched_free:
            ir = ir.with_note(
                "superstep: touched-mask elided (apply(x, identity) == x)")
        step = FusedSuperstepOp(fused=fused, apply=aop, frontier=fop,
                                pull_sweep=sweep, touched_free=touched_free)
        ops = []
        for op in ir.ops:
            if op is fused:
                ops.append(step)
            elif op is aop or op is fop:
                continue
            else:
                ops.append(op)
        return ir.replace(ops=tuple(ops)).with_note(
            "superstep fused: gather+reduce -> apply -> frontier emit as "
            "one stage")


def default_pipeline() -> PassPipeline:
    """The translator's standard pass order (see module docstring)."""
    return PassPipeline([
        ProgramAnalysisPass(),
        GatherClassificationPass(),
        DirectionLegalityPass(),
        ReduceIdentityFoldPass(),
        BackendSelectionPass(),
        GatherReduceFusionPass(),
        DeadFrontierEliminationPass(),
        SuperstepFusionPass(),
    ])
