"""Typed superstep IR (paper §V): the translator's intermediate language.

Counterpart of ``repro.core.ir``; only the dtype handling differs (torch
dtypes).  Backend flavors are ``'dense_cuda'`` (the hand-written CUDA
kernels), ``'dense_torch'`` (plain PyTorch on the CPU) and
``'sparse_torch'`` (the sparse backend's PyTorch scatters, on either
device).

The paper's light-weight translator avoids general HLS by staging a DSL
program through a *small number of well-chosen representations* before
emitting optimized modules.  This module defines the middle representation:
a :class:`SuperstepIR` — a short, typed op list describing one GAS
superstep — produced from a :class:`~repro_torch.core.dsl.VertexProgram` by
:func:`lower_program` (the front-end lowering), rewritten by the passes in
:mod:`repro_torch.core.passes`, and finally walked by
:func:`repro_torch.core.translator.translate` (the translation stage) to emit the
superstep.

Ops mirror the paper's hardware modules:

* :class:`GatherOp`        — per-edge message construction (Receive),
* :class:`ReduceOp`        — per-vertex accumulation,
* :class:`FusedGatherReduceOp` — a matched gather+reduce pair bound to one
  pre-built kernel (the ELL edge-block module or the sparse segment-scan),
* :class:`PushScatterOp`   — the push-direction twin of the fused pair: a
  frontier-compacted scatter over forward (out-)edges, inserted by the
  fusion pass when the direction-legality analysis proved push legal,
* :class:`ApplyOp`         — vertex update,
* :class:`FrontierUpdateOp`— next-frontier computation,
* :class:`ExchangeOp`      — cross-PE combine (the comm manager's plane),
* :class:`FusedSuperstepOp`— the whole ``FusedGatherReduce → Apply →
  FrontierUpdate`` triple fused into one emitted stage (inserted by the
  superstep-fusion pass when the apply is provably elementwise), which
  also binds the pull plane's data path — the block-skipping
  bitmap-frontier sweep vs the dense full sweep.

Edge processing carries a *direction*: ``'pull'`` (the canonical lowering —
every vertex gathers over its in-edges) or ``'both'`` once the
direction-legality pass proves the push form equivalent (commutative
reduce with identity masking, sparse ``'changed'`` frontier).  Programs
pinned to pull record the reason as an IR note, visible in pass dumps.

Everything is an immutable dataclass; passes rewrite with
``dataclasses.replace`` so each pipeline stage has a well-defined
before/after that :meth:`SuperstepIR.dump` can render (the observable
"TT"-style report documented in ``docs/architecture.md``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .dsl import VertexProgram

__all__ = [
    "GatherOp",
    "ReduceOp",
    "FusedGatherReduceOp",
    "PushScatterOp",
    "ApplyOp",
    "FrontierUpdateOp",
    "ExchangeOp",
    "FusedSuperstepOp",
    "SuperstepIR",
    "lower_program",
]


def _fn_name(fn: Callable) -> str:
    """Best-effort printable name for a user callable (for dumps only)."""
    name = getattr(fn, "__name__", None) or type(fn).__name__
    return "<lambda>" if name == "<lambda>" else name


@dataclasses.dataclass(frozen=True)
class GatherOp:
    """Per-edge message construction: ``msg = fn(src_value, weight, degree)``.

    ``module`` is ``None`` until the gather-classification pass matches
    ``fn`` against the pre-built module menu (``kernels.ref.GATHER_OPS``);
    an unmatched gather keeps ``module=None`` and forces the general sparse
    path (nothing is rejected, only de-optimized).

    ``direction`` starts as ``'pull'`` (the canonical lowering) and is
    widened to ``'both'`` by the direction-legality pass when the push
    (scatter-over-out-edges) form is provably equivalent.
    """

    fn: Callable
    module: str | None = None
    direction: str = "pull"          # 'pull' | 'both'

    def render(self) -> str:
        """One-line textual form used in IR dumps."""
        mod = self.module if self.module is not None else "?"
        return (f"Gather(fn={_fn_name(self.fn)}, module={mod}, "
                f"direction={self.direction})")


@dataclasses.dataclass(frozen=True)
class ReduceOp:
    """Per-vertex accumulation of gathered messages (``add``/``min``/``max``).

    ``identity`` is ``None`` until the reduce-identity folding pass
    constant-folds the op's neutral element for the program dtype.
    """

    op: str
    identity: Any = None

    def render(self) -> str:
        """One-line textual form used in IR dumps."""
        ident = "?" if self.identity is None else repr(self.identity)
        return f"Reduce(op={self.op}, identity={ident})"


@dataclasses.dataclass(frozen=True)
class FusedGatherReduceOp:
    """A gather+reduce pair fused onto one pre-built edge-processing kernel.

    Produced by the fusion pass once the backend is known: ``kernel`` is
    ``'edge_block'`` (the dense ELL module: CUDA kernel or plain PyTorch) or ``'segment_scan'``
    (the chunk-streamed sparse segment-reduce module).  ``direction`` is
    copied from the gather op: ``'both'`` means the fusion pass also
    inserted the push-mode :class:`PushScatterOp` twin.
    """

    gather: GatherOp
    reduce: ReduceOp
    kernel: str
    direction: str = "pull"          # 'pull' | 'both'

    def render(self) -> str:
        """One-line textual form used in IR dumps."""
        return (f"FusedGatherReduce(kernel={self.kernel}, "
                f"direction={self.direction}, "
                f"gather={self.gather.render()}, "
                f"reduce={self.reduce.render()})")


@dataclasses.dataclass(frozen=True)
class PushScatterOp:
    """Push-direction edge processing: frontier-compacted forward scatter.

    The dual of :class:`FusedGatherReduceOp`: instead of every vertex
    gathering over its in-edges, only *active* vertices scatter messages
    along their out-edges (``red[dst] ⊕= gather(values[src], w, deg)``).
    Legal only when the direction-legality pass proved the reduce
    commutative with identity masking and the frontier sparse
    (``frontier='changed'``, ``mask_inactive=True``) — exactly then the
    scatter touches ``Σ out_deg(frontier)`` edges instead of all ``E``.

    ``layout`` names the push data path the fusion pass bound:

    * ``'fwd_ell'`` — the frontier-compacted forward-ELL engine
      (``kernels/push_ell.py``): cumsum-compacted active rows, capacity
      tiers, segment-reduce combine, dense-engine fallback beyond the
      largest tier.  Requires the dense backend and an identity-fixpoint
      apply (``apply(x, identity) == x``, probed) since it skips the
      touched-mask scatter.  This is also the only multi-PE-shardable
      layout: under ``pes > 1`` the translator partitions the forward ELL
      into disjoint per-PE row intervals and combines the partial tables
      with the reduce-matched collective (the IR's resolved
      :class:`ExchangeOp`);
    * ``'coo_chunks'`` — the chunk-streamed forward-COO scatter
      (``kernels/push_scatter.py``), for the sparse backend (no forward
      ELL is built) and for non-fixpoint applies (it keeps the touched
      mask).  Single-PE only; multi-PE plans that would need it pin to
      pull instead (the legality pass notes why).

    Emitted by the fusion pass alongside the pull op; the translator emits
    *both* supersteps and the runtime direction policy picks per superstep.
    """

    gather: GatherOp
    reduce: ReduceOp
    kernel: str = "push_scatter"
    layout: str = "fwd_ell"          # 'fwd_ell' | 'coo_chunks'

    def render(self) -> str:
        """One-line textual form used in IR dumps."""
        return (f"PushScatter(kernel={self.kernel}, layout={self.layout}, "
                f"gather={self.gather.render()}, "
                f"reduce={self.reduce.render()})")


@dataclasses.dataclass(frozen=True)
class ApplyOp:
    """Vertex update: ``new_value = fn(old_value, reduced_msg)``."""

    fn: Callable

    def render(self) -> str:
        """One-line textual form used in IR dumps."""
        return f"Apply(fn={_fn_name(self.fn)})"


@dataclasses.dataclass(frozen=True)
class FrontierUpdateOp:
    """Next-frontier computation.

    ``mode`` mirrors the DSL's frontier semantics (``'changed'`` computes a
    change mask; ``'all'`` keeps every vertex active).  The dead-frontier
    elimination pass sets ``dead=True`` for ``'all'`` programs so the
    translation stage skips the change-mask computation entirely.
    """

    mode: str
    dead: bool = False

    def render(self) -> str:
        """One-line textual form used in IR dumps."""
        tag = ", dead" if self.dead else ""
        return f"FrontierUpdate(mode={self.mode}{tag})"


@dataclasses.dataclass(frozen=True)
class ExchangeOp:
    """Cross-PE combine of the partial per-vertex reductions.

    ``pes``/``collective`` are unresolved (``None``) until the
    backend-selection pass consumes the scheduler plan; with one PE the
    pass deletes this op from the pipeline instead.  Which plane the
    resolved exchange serves depends on the backend: the sparse plan
    shards the *pull* sweep (per-PE edge-chunk slices), the dense plan
    shards the *push* engine (per-PE forward-ELL row intervals) and keeps
    the pull sweep replicated.
    """

    reduce: str
    pes: int | None = None
    collective: str | None = None

    def render(self) -> str:
        """One-line textual form used in IR dumps."""
        pes = "?" if self.pes is None else self.pes
        coll = self.collective if self.collective is not None else "?"
        return f"Exchange(reduce={self.reduce}, pes={pes}, collective={coll})"


@dataclasses.dataclass(frozen=True)
class FusedSuperstepOp:
    """A whole superstep fused into one emitted stage.

    Produced by the superstep-fusion pass when the apply is provably
    *elementwise* (probed like module matching): the
    ``FusedGatherReduce → Apply → FrontierUpdate`` triple collapses so the
    reduced per-vertex values flow straight into the apply and the
    change-mask computation inside a single emitted stage — no
    device-memory ``(V,)`` intermediates crossing stage boundaries.  The
    member ops keep their full annotations (the translation stage reads
    them through this wrapper).

    ``pull_sweep`` names the pull plane's data path, bound here because
    only a fused stage can skip work:

    * ``'bitmap'`` — the block-skipping bitmap-frontier sweep
      (``kernels/pull_bitmap.py``): a per-superstep touched summary from
      a compacted forward pass, per-block any-active liveness, compacted
      live-block gather, scatter-free row→vertex combine.  Requires
      ``mask_inactive=True`` (skipping relies on inactive sources
      contributing nothing), a sparse ``'changed'`` frontier (an ``'all'``
      frontier keeps every block live — nothing to skip), the dense
      backend (the blocks are the reversed bucketed ELL's), and an
      un-sharded pull plane (the sparse multi-PE plan streams per-PE COO
      chunks instead).  *No* reduce restriction: skipping never reorders
      a surviving row's lane reduction, so even float ``add`` stays
      bit-exact — a strictly weaker requirement than push legality.
    * ``'dense'`` — the full masked sweep (every block, every superstep);
      the decline reason is recorded as an IR note.
    """

    fused: FusedGatherReduceOp
    apply: ApplyOp
    frontier: FrontierUpdateOp
    pull_sweep: str = "dense"        # 'dense' | 'bitmap'
    # apply is an identity fixpoint (``apply(x, identity) == x``, probed):
    # untouched vertices are fixpoints of the fused stage, so the emitted
    # superstep applies the reduced table everywhere and the touched-mask
    # plane (its gathers and its any-reduce) is never computed at all
    touched_free: bool = False

    def render(self) -> str:
        """One-line textual form used in IR dumps."""
        return (f"FusedSuperstep(pull_sweep={self.pull_sweep}, "
                f"touched_free={self.touched_free}, "
                f"fused={self.fused.render()}, "
                f"apply={self.apply.render()}, "
                f"frontier={self.frontier.render()})")


IROp = Any  # union of the op dataclasses above (kept informal: plain tags)


@dataclasses.dataclass(frozen=True)
class SuperstepIR:
    """One GAS superstep as a typed op list plus program metadata.

    ``backend`` starts as ``None`` and is resolved to a concrete kernel
    flavor (``'dense_cuda'`` | ``'dense_torch'`` | ``'sparse_torch'``) by the
    backend-selection pass.  ``facts`` is the program-analysis pass's
    :class:`~repro_torch.core.analysis.ProgramAnalysis` (``None`` until that
    pass runs; downstream passes recompute lazily via the analysis cache
    when driven standalone in tests).  ``notes`` accumulates free-form
    strings recorded by passes — a **legacy channel**, deprecated in
    favor of the typed diagnostics on ``PassContext``: notes stay for
    dump readability and existing substring-pinned tests, but new facts
    should be :class:`~repro_torch.core.diagnostics.Diagnostic` entries.
    """

    program: VertexProgram
    ops: tuple
    backend: str | None = None
    notes: tuple = ()
    facts: Any = None                # ProgramAnalysis | None (analysis pass)

    @property
    def value_dtype(self) -> torch.dtype:
        """The program's vertex-value dtype."""
        return self.program.value_dtype

    def replace(self, **kw) -> "SuperstepIR":
        """Functional update (``dataclasses.replace`` sugar for passes)."""
        return dataclasses.replace(self, **kw)

    def with_note(self, note: str) -> "SuperstepIR":
        """Append an analysis note (recorded facts, shown in dumps)."""
        return self.replace(notes=self.notes + (note,))

    def find(self, kind) -> IROp | None:
        """Return the first op of dataclass ``kind``, or ``None``."""
        for op in self.ops:
            if isinstance(op, kind):
                return op
        return None

    def replace_op(self, old: IROp, new: IROp | None) -> "SuperstepIR":
        """Rewrite ``old`` → ``new`` in the op list (``None`` deletes)."""
        ops = []
        for op in self.ops:
            if op is old:
                if new is not None:
                    ops.append(new)
            else:
                ops.append(op)
        return self.replace(ops=tuple(ops))

    def fuse(self, gather: GatherOp, reduce: ReduceOp,
             fused: FusedGatherReduceOp) -> "SuperstepIR":
        """Replace an adjacent gather+reduce pair with ``fused``."""
        ops = []
        for op in self.ops:
            if op is gather:
                ops.append(fused)
            elif op is reduce:
                continue
            else:
                ops.append(op)
        return self.replace(ops=tuple(ops))

    def dump(self) -> str:
        """Readable multi-line IR listing (the pipeline's observable form)."""
        p = self.program
        dtype = str(self.value_dtype).replace("torch.", "")
        head = (f"superstep {p.name}: dtype={dtype} "
                f"frontier={p.frontier} mask_inactive={p.mask_inactive} "
                f"max_iters={p.max_iters} "
                f"backend={self.backend or '?'}")
        lines = [head]
        for i, op in enumerate(self.ops):
            lines.append(f"  %{i} = {op.render()}")
        for note in self.notes:
            lines.append(f"  ; {note}")
        return "\n".join(lines)


def lower_program(program: VertexProgram) -> SuperstepIR:
    """Front-end lowering: ``VertexProgram`` → unoptimized :class:`SuperstepIR`.

    The op list is the canonical pull-mode GAS superstep — gather per
    in-edge, reduce per vertex, a (possibly elided) cross-PE exchange,
    vertex apply, frontier update.  No analysis happens here; every
    annotation slot (gather module, reduce identity, backend, exchange
    collective) is left unresolved for the pass pipeline.
    """
    return SuperstepIR(
        program=program,
        ops=(
            GatherOp(fn=program.gather),
            ReduceOp(op=program.reduce),
            ExchangeOp(reduce=program.reduce),
            ApplyOp(fn=program.apply),
            FrontierUpdateOp(mode=program.frontier),
        ),
    )
