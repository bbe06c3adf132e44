"""Program analysis by sampling probes, and the structural IR verifier.

Counterpart of ``repro.core.analysis`` without its jaxpr tier: every
property the pass pipeline needs is decided by evaluating the user's
gather or apply on fixed seeded batches (provenance ``'probed'``).  A
probe is evidence, not proof — a callable that misbehaves only outside
the batch slips through — which is why the JAX package decides these
statically where it can.  The static tier over torch.fx traces is queued
in ``ROADMAP.md`` (§1 item 6).

:func:`verify_ir` is structural and carries over unchanged: the pass
pipeline runs it between every pass pair under ``verify=True``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from ..kernels.ref import GATHER_OPS, gather_msg
from .diagnostics import Diagnostic
from .dsl import VertexProgram, reduce_identity

__all__ = [
    "PropertyFact",
    "ProgramAnalysis",
    "analyze_program",
    "verify_ir",
    "classify_gather",
    "apply_preserves_identity",
    "gather_absorbs_identity",
    "apply_is_elementwise",
    "apply_batches_over_lanes",
    "gather_uses_weight",
    "is_monotone",
]

_COMMUTATIVE_REDUCES = ("add", "min", "max")

_PROVENANCES = ("static", "probed", "declined")


@dataclasses.dataclass(frozen=True)
class PropertyFact:
    """One analyzed property: its verdict and how it was reached."""

    value: object
    provenance: str
    detail: str = ""

    def __post_init__(self):
        if self.provenance not in _PROVENANCES:
            raise ValueError(f"unknown provenance: {self.provenance!r}")


@dataclasses.dataclass(frozen=True)
class ProgramAnalysis:
    """All analyzed facts for one :class:`~repro_torch.core.dsl.VertexProgram`.

    ``gather_module`` feeds gather classification, ``weight_use`` the
    pull sweep's table mode, ``elementwise`` superstep fusion,
    ``identity_fixpoint`` the push layout and touched-mask elision,
    ``identity_absorbing`` the masked sweep, and ``monotone`` is
    termination evidence for ``'changed'``-frontier programs.
    """

    gather_module: PropertyFact      # str | None
    weight_use: PropertyFact         # bool
    elementwise: PropertyFact        # bool
    identity_fixpoint: PropertyFact  # bool
    identity_absorbing: PropertyFact # bool
    monotone: PropertyFact           # bool
    diagnostics: tuple = ()

    def summary(self) -> dict:
        """``{property: (value, provenance)}``."""
        return {
            f.name: (getattr(self, f.name).value,
                     getattr(self, f.name).provenance)
            for f in dataclasses.fields(self)
            if f.name != "diagnostics"
        }


# ---------------------------------------------------------------------------
# Sampling probes
# ---------------------------------------------------------------------------


def _weight_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype if dtype.is_floating_point else torch.float32


def _batch(values, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values)).to(dtype)


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-level agreement for the probes (NaN equals NaN)."""
    return a.shape == b.shape and bool(
        np.array_equal(a.numpy(), b.numpy(), equal_nan=True))


def classify_gather(gather: Callable, dtype: torch.dtype) -> str | None:
    """Match a gather callable against the menu by sampling probe.

    Evaluates the gather on a fixed random batch and compares against
    every menu entry (``kernels.ref.GATHER_OPS``); returns the matched
    module name, or ``None`` for the general path.
    """
    rng = np.random.default_rng(0)
    v = _batch(rng.uniform(1, 8, (16,)), dtype)
    w = _batch(rng.uniform(1, 8, (16,)), _weight_dtype(dtype)).to(dtype)
    d = _batch(rng.integers(1, 9, (16,)), torch.int32)
    try:
        got = gather(v, w, d).numpy()
    except Exception:
        return None
    for name in GATHER_OPS:
        want = gather_msg(name, v, w, d).numpy()
        if got.shape == want.shape and np.allclose(got, want, rtol=1e-5,
                                                   atol=1e-5):
            return name
    return None


def gather_uses_weight(gather: Callable, dtype: torch.dtype) -> bool:
    """Probe whether the message depends on the edge weight: evaluate
    with two different weight batches and compare."""
    rng = np.random.default_rng(3)
    v = _batch(rng.uniform(1, 8, (16,)), dtype)
    d = _batch(rng.integers(1, 9, (16,)), torch.int32)
    w1 = _batch(rng.uniform(1, 8, (16,)), _weight_dtype(dtype)).to(dtype)
    w2 = _batch(rng.uniform(9, 16, (16,)), _weight_dtype(dtype)).to(dtype)
    try:
        return not _equal(gather(v, w1, d), gather(v, w2, d))
    except Exception:
        return True


def apply_preserves_identity(apply: Callable, reduce: str,
                             dtype: torch.dtype) -> bool:
    """Probe whether ``apply(x, identity) == x`` bit-exactly.

    When it holds an untouched vertex is a fixpoint of the superstep, so
    the push engine applies the reduced table everywhere and skips the
    touched mask.
    """
    ident = reduce_identity(reduce, dtype)
    rng = np.random.default_rng(0)
    if dtype.is_floating_point:
        info = torch.finfo(dtype)
        probes = np.concatenate([
            rng.uniform(-8, 8, 13), [0.0, info.max / 2, -info.max / 2]])
    else:
        info = torch.iinfo(dtype)
        probes = np.concatenate([
            rng.integers(-8, 8, 13), [0, info.max - 1, info.min + 1]])
    x = _batch(probes, dtype)
    try:
        got = apply(x, torch.full_like(x, ident.item()))
    except Exception:
        return False
    return _equal(got, x)


def gather_absorbs_identity(gather: Callable, reduce: str,
                            dtype: torch.dtype) -> bool:
    """Probe whether ``gather(identity, w, d) == identity`` for any
    weight and degree (SSSP: ``inf + w == inf``)."""
    ident = reduce_identity(reduce, dtype)
    rng = np.random.default_rng(2)
    w = _batch(rng.uniform(-8, 8, (16,)), _weight_dtype(dtype)).to(dtype)
    d = _batch(rng.integers(1, 9, (16,)), torch.int32)
    x = torch.full((16,), ident.item(), dtype=dtype)
    try:
        got = gather(x, w, d)
    except Exception:
        return False
    return _equal(got, torch.full((16,), ident.item(), dtype=dtype))


def apply_is_elementwise(apply: Callable, dtype: torch.dtype) -> bool:
    """Probe whether output ``i`` of ``apply`` depends only on
    ``(old[i], reduced[i])``: shape preservation, per-element agreement,
    and locality under a one-slot perturbation."""
    rng = np.random.default_rng(1)
    n = 8
    if dtype.is_floating_point:
        xs = rng.uniform(-8, 8, (2, n))
    else:
        xs = rng.integers(-8, 8, (2, n))
    x = _batch(xs[0], dtype)
    r = _batch(xs[1], dtype)
    try:
        full = apply(x, r)
        if full.shape != (n,):
            return False
        per = torch.stack([apply(x[i:i + 1], r[i:i + 1])[0]
                           for i in range(n)])
        if not _equal(full, per):
            return False
        for k in (0, n - 1):
            x2, r2 = x.clone(), r.clone()
            x2[k] += 1
            r2[k] += 1
            out2 = apply(x2, r2)
            others = torch.arange(n) != k
            if not _equal(full[others], out2[others]):
                return False
    except Exception:
        return False
    return True


def apply_batches_over_lanes(apply: Callable, dtype: torch.dtype,
                             num_vertices: int) -> bool:
    """Probe whether ``apply`` on a ``(2, V)`` batch of lanes gives each
    lane what it gives that lane alone, at the graph's own ``V``.

    The lane API runs an apply that passes this once on a whole batch of
    lanes, and any other lane by lane.  The 1-D elementwise probe alone is
    not enough: an apply that reads the length of its input (ppr's
    restart vector, ``arange(s.shape[0]) == root``) looks elementwise on
    8 probe slots for a root past them, and reads the lane count on a
    batch.
    """
    rng = np.random.default_rng(2)
    shape = (2, max(int(num_vertices), 1))
    if dtype.is_floating_point:
        xs = rng.uniform(-8, 8, (2, *shape))
    else:
        xs = rng.integers(-8, 8, (2, *shape))
    x = _batch(xs[0], dtype)
    r = _batch(xs[1], dtype)
    try:
        both = apply(x, r)
        per = torch.stack([apply(x[i], r[i]) for i in range(2)])
    except Exception:
        return False
    return _equal(both, per)


def is_monotone(program: VertexProgram) -> bool:
    """Probe termination evidence for a min/max program: the apply is the
    reduce's clamp ``min/max(old, reduced)`` and the gather is the source
    value plus an offset of the sign the reduce needs (non-negative
    weights, as ``validate_graph`` requires under ``min``).  Integer-valued
    batches keep float arithmetic exact."""
    if program.reduce not in ("min", "max"):
        return False
    dtype = program.value_dtype
    clamp = torch.minimum if program.reduce == "min" else torch.maximum
    rng = np.random.default_rng(4)
    x = _batch(rng.integers(-8, 8, 16), dtype)
    r = _batch(rng.integers(-8, 8, 16), dtype)
    v = _batch(rng.integers(0, 64, 16), dtype)
    w = _batch(rng.integers(0, 8, 16), dtype)
    d = _batch(rng.integers(1, 9, 16), torch.int32)
    try:
        if not _equal(program.apply(x, r), clamp(x, r)):
            return False
        off = program.gather(v, w, d) - v
        shifted = program.gather(v + 3, w, d) - (v + 3)
    except Exception:
        return False
    if not _equal(off, shifted):
        return False
    return bool((off >= 0).all() if program.reduce == "min"
                else (off <= 0).all())


# ---------------------------------------------------------------------------
# analyze_program (cached)
# ---------------------------------------------------------------------------


def _overflow_diags(program: VertexProgram, diags: list) -> None:
    """A003: does ``gather(init)`` wrap the integer value dtype?"""
    dtype = program.value_dtype
    if dtype.is_floating_point or dtype == torch.int64:
        return
    init = program.init_value
    if isinstance(init, str) or callable(init) \
            or not (np.isscalar(init) or np.ndim(init) == 0):
        return
    info = torch.iinfo(dtype)
    i = int(init)
    if i < info.min or i > info.max:
        diags.append(Diagnostic(
            "A003", "error", "init",
            f"init value {i} does not fit the value dtype {dtype} "
            f"(range [{info.min}, {info.max}]) — it wraps before the "
            "first superstep",
            f"use an init below {info.max} or widen value_dtype"))
        return
    rng = np.random.default_rng(5)
    w = rng.integers(0, 9, 8)
    d = torch.as_tensor(rng.integers(1, 9, 8)).to(torch.int32)
    try:
        narrow = program.gather(torch.full((8,), i, dtype=dtype),
                                torch.as_tensor(w).to(dtype), d)
        wide = program.gather(torch.full((8,), i, dtype=torch.int64),
                              torch.as_tensor(w).to(torch.int64), d)
    except Exception:
        return
    if narrow.dtype == dtype and not torch.equal(narrow.to(torch.int64),
                                                 wide.to(torch.int64)):
        diags.append(Diagnostic(
            "A003", "error", "gather",
            f"gather evaluated at the init value {i} overflows {dtype} — "
            "messages from unvisited sources silently wrap at runtime",
            "lower the init (e.g. bfs_program's default 2**30) or widen "
            "value_dtype"))


def _lattice_diags(program: VertexProgram, facts: dict, diags: list) -> None:
    """A004 (absorbing init) and A007 (no termination evidence)."""
    init = program.init_value
    ident = reduce_identity(program.reduce, program.value_dtype)
    init_is_ident = False
    if not isinstance(init, str) and not callable(init) \
            and (np.isscalar(init) or np.ndim(init) == 0):
        init_is_ident = bool(torch.tensor(init).to(ident.dtype) == ident)
    if init_is_ident and facts["identity_absorbing"].value \
            and facts["identity_fixpoint"].value:
        diags.append(Diagnostic(
            "A004", "warning", "init",
            f"init value equals the '{program.reduce}' reduce identity "
            f"({ident.item()}) everywhere, the gather absorbs it and the "
            "apply fixes it: no superstep changes any vertex until a "
            "source is seeded",
            "seed at least one vertex away from the identity (the "
            "algorithm layer's root injection) before running"))
    if program.frontier == "changed" and program.max_iters is None \
            and not facts["monotone"].value:
        diags.append(Diagnostic(
            "A007", "info", "program",
            "frontier='changed' with no max_iters and no "
            "monotone-convergence evidence — only the superstep budget "
            "bounds the run",
            "set max_iters, or use a min/max clamp apply"))


_ANALYSIS_CACHE: OrderedDict = OrderedDict()
_ANALYSIS_CACHE_MAX = 64


def analyze_program(program: VertexProgram) -> ProgramAnalysis:
    """Decide every property the pass pipeline needs by probe (cached per
    program object; the template factories are memoized, so repeat
    translations pay nothing)."""
    try:
        hash(program)                    # unhashable programs skip the cache
        key = program
    except TypeError:
        key = None
    if key is not None and key in _ANALYSIS_CACHE:
        _ANALYSIS_CACHE.move_to_end(key)
        return _ANALYSIS_CACHE[key]

    dtype = program.value_dtype

    def probed(value, detail):
        return PropertyFact(value, "probed", detail)

    module = classify_gather(program.gather, dtype)
    facts = {
        "gather_module": probed(module, "16-element probe against the menu"),
        "weight_use": probed(gather_uses_weight(program.gather, dtype),
                             "two weight batches compared"),
        "elementwise": probed(apply_is_elementwise(program.apply, dtype),
                              "per-element and locality probe"),
        "identity_fixpoint": probed(
            apply_preserves_identity(program.apply, program.reduce, dtype),
            "apply(x, identity) == x on the probe batch"),
        "identity_absorbing": probed(
            gather_absorbs_identity(program.gather, program.reduce, dtype),
            "gather(identity, w, d) == identity on the probe batch"),
        "monotone": probed(is_monotone(program),
                           "clamp apply and signed gather offset probe"),
    }
    diags: list = [Diagnostic(
        "A001", "info", "program",
        "every property was decided by sampling probe (the port has no "
        "static tier yet)", "")]
    _overflow_diags(program, diags)
    _lattice_diags(program, facts, diags)

    result = ProgramAnalysis(diagnostics=tuple(diags), **facts)
    if key is not None:
        _ANALYSIS_CACHE[key] = result
        while len(_ANALYSIS_CACHE) > _ANALYSIS_CACHE_MAX:
            _ANALYSIS_CACHE.popitem(last=False)
    return result


# ---------------------------------------------------------------------------
# IR verifier (structural invariants between passes)
# ---------------------------------------------------------------------------

# Canonical superstep order: ranks must be non-decreasing along ``ir.ops``.
_OP_RANK = {
    "GatherOp": 0,
    "FusedGatherReduceOp": 1,
    "FusedSuperstepOp": 1,
    "ReduceOp": 2,
    "PushScatterOp": 3,
    "ExchangeOp": 4,
    "ApplyOp": 5,
    "FrontierUpdateOp": 6,
}

_EXCHANGE_COLLECTIVES = {"add": "psum", "min": "pmin", "max": "pmax"}
_BACKENDS = ("dense_cuda", "dense_torch", "sparse_torch")


def _v(code, op, message, suggestion=""):
    return Diagnostic(code, "error", op, message, suggestion)


def verify_ir(ir, ctx=None) -> list:
    """Check :class:`~repro_torch.core.ir.SuperstepIR` structural invariants.

    Returns a list of error-severity ``V*`` diagnostics, empty for a
    well-formed IR; ``ctx`` enables the plan-agreement check (V007).
    """
    from .ir import (ExchangeOp, FrontierUpdateOp, FusedGatherReduceOp,
                     FusedSuperstepOp, GatherOp, PushScatterOp, ReduceOp)

    program = ir.program
    out = []
    counts: dict = {}
    for op in ir.ops:
        counts[type(op).__name__] = counts.get(type(op).__name__, 0) + 1

    # V001 — op multiplicity
    for name, n in counts.items():
        if n > 1:
            out.append(_v("V001", name, f"{n} {name} ops in one superstep "
                          "(each stage appears at most once)"))
    gather_planes = sum(counts.get(n, 0) for n in
                        ("GatherOp", "FusedGatherReduceOp",
                         "FusedSuperstepOp"))
    if gather_planes != 1:
        out.append(_v("V001", "Gather",
                      f"{gather_planes} gather-plane ops (exactly one of "
                      "Gather/FusedGatherReduce/FusedSuperstep required)"))
    fused_any = counts.get("FusedGatherReduceOp", 0) \
        + counts.get("FusedSuperstepOp", 0)
    if bool(counts.get("ReduceOp", 0)) == bool(fused_any):
        out.append(_v("V001", "Reduce",
                      "ReduceOp must be present exactly when no fused "
                      "gather+reduce op is"))
    step = ir.find(FusedSuperstepOp)
    for name in ("ApplyOp", "FrontierUpdateOp"):
        if bool(counts.get(name, 0)) == (step is not None):
            out.append(_v("V001", name,
                          f"{name} must be present exactly when the "
                          "superstep is not fused into one stage"))

    # V002 — op ordering
    ranks = [_OP_RANK.get(type(op).__name__) for op in ir.ops]
    if None in ranks:
        bad = type(ir.ops[ranks.index(None)]).__name__
        out.append(_v("V002", bad, f"unknown op class {bad} in the IR"))
    elif any(a > b for a, b in zip(ranks, ranks[1:])):
        out.append(_v("V002", "ops",
                      "ops out of canonical superstep order "
                      "(gather → reduce → push → exchange → apply → "
                      "frontier): "
                      + " -> ".join(type(o).__name__ for o in ir.ops)))

    gop = ir.find(GatherOp)
    fgr = ir.find(FusedGatherReduceOp)
    if step is not None:
        fgr = step.fused
    if gop is None and fgr is not None:
        gop = fgr.gather
    rop = ir.find(ReduceOp)
    if rop is None and fgr is not None:
        rop = fgr.reduce

    # V003 — reduce consistency
    if rop is not None:
        if rop.op != program.reduce:
            out.append(_v("V003", "Reduce",
                          f"reduce op {rop.op!r} disagrees with the "
                          f"program's {program.reduce!r}"))
        if rop.identity is not None:
            want = reduce_identity(rop.op, ir.value_dtype)
            got = torch.as_tensor(rop.identity)
            if got.dtype != ir.value_dtype or not _equal(got, want):
                out.append(_v(
                    "V003", "Reduce",
                    f"folded identity {rop.identity!r} is not "
                    f"reduce_identity({rop.op!r}, {ir.value_dtype})"))

    # V004 — gather module annotation
    if gop is not None and gop.module is not None \
            and gop.module not in GATHER_OPS:
        out.append(_v("V004", "Gather",
                      f"annotated module {gop.module!r} names no menu "
                      f"module (menu: {', '.join(GATHER_OPS)})"))

    # V005 — direction legality preconditions
    push = ir.find(PushScatterOp)
    direction = gop.direction if gop is not None else "pull"
    if fgr is not None:
        direction = fgr.direction
    if direction == "both" or push is not None:
        reasons = []
        if program.reduce not in _COMMUTATIVE_REDUCES:
            reasons.append(f"reduce {program.reduce!r} is not commutative")
        if program.reduce == "add" and ir.value_dtype.is_floating_point:
            reasons.append("float add is order-sensitive")
        if not program.mask_inactive:
            reasons.append("mask_inactive=False")
        if program.frontier != "changed":
            reasons.append(f"frontier={program.frontier!r}")
        if reasons:
            out.append(_v("V005", "PushScatter" if push else "Gather",
                          "push direction bound without its preconditions: "
                          + "; ".join(reasons)))

    # V006 — backend/kernel agreement
    if ir.backend is not None:
        if ir.backend not in _BACKENDS:
            out.append(_v("V006", "backend",
                          f"unknown backend {ir.backend!r}"))
        if fgr is not None:
            want = "edge_block" if ir.backend.startswith("dense") \
                else "segment_scan"
            if fgr.kernel != want:
                out.append(_v("V006", "FusedGatherReduce",
                              f"kernel {fgr.kernel!r} disagrees with "
                              f"backend {ir.backend!r} (expected {want!r})"))
        if push is not None and push.layout == "fwd_ell" \
                and not ir.backend.startswith("dense"):
            out.append(_v("V006", "PushScatter",
                          "fwd_ell push layout needs a dense backend "
                          f"(backend is {ir.backend!r})"))
    elif fgr is not None:
        out.append(_v("V006", "FusedGatherReduce",
                      "gather+reduce fused before a backend was resolved"))

    # V007 — exchange-plane consistency
    xop = ir.find(ExchangeOp)
    if xop is not None:
        if xop.reduce != program.reduce:
            out.append(_v("V007", "Exchange",
                          f"exchange reduce {xop.reduce!r} disagrees with "
                          f"the program's {program.reduce!r}"))
        if xop.collective is not None:
            want = _EXCHANGE_COLLECTIVES.get(xop.reduce)
            if xop.collective != want:
                out.append(_v("V007", "Exchange",
                              f"collective {xop.collective!r} is not the "
                              f"reduce-matched {want!r}"))
            if xop.pes is None or xop.pes <= 1:
                out.append(_v("V007", "Exchange",
                              "resolved collective with pes <= 1 (a "
                              "single-PE exchange should be elided)"))
            if ctx is not None and xop.pes is not None \
                    and xop.pes != ctx.plan.pes:
                out.append(_v("V007", "Exchange",
                              f"exchange pes={xop.pes} disagrees with the "
                              f"schedule plan's pes={ctx.plan.pes}"))

    # V008 — frontier consistency
    fop = ir.find(FrontierUpdateOp)
    if fop is None and step is not None:
        fop = step.frontier
    if fop is not None:
        if fop.mode != program.frontier:
            out.append(_v("V008", "FrontierUpdate",
                          f"frontier mode {fop.mode!r} disagrees with the "
                          f"program's {program.frontier!r}"))
        if fop.dead and fop.mode != "all":
            out.append(_v("V008", "FrontierUpdate",
                          "frontier marked dead but mode is "
                          f"{fop.mode!r} (only 'all' frontiers are dead)"))

    # V009 — fused-superstep binding preconditions
    if step is not None:
        if step.pull_sweep == "bitmap":
            reasons = []
            if not program.mask_inactive:
                reasons.append("mask_inactive=False")
            if program.frontier != "changed":
                reasons.append(f"frontier={program.frontier!r}")
            if not (ir.backend or "").startswith("dense"):
                reasons.append(f"backend {ir.backend!r} is not dense")
            if reasons:
                out.append(_v("V009", "FusedSuperstep",
                              "bitmap pull sweep bound without its "
                              "preconditions: " + "; ".join(reasons)))
        if step.touched_free and program.frontier != "changed":
            out.append(_v("V009", "FusedSuperstep",
                          "touched-mask elision bound with "
                          f"frontier={program.frontier!r} (needs "
                          "'changed')"))
    return out
