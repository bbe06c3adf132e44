"""Structured diagnostics for the translator (paper: user-facing legality).

The pass pipeline used to smuggle its analysis facts around as free-form
strings in ``SuperstepIR.notes``.  This module gives legality findings a
*typed* channel: a :class:`Diagnostic` carries a stable code from
:data:`DIAGNOSTIC_CODES`, a severity, the op/program element it anchors
to, and a suggestion — machine-checkable (golden tests pin them, the lint
CLI tables them, ``translate(..., strict=True)`` promotes them to typed
:mod:`repro_torch.errors` exceptions) where a note substring never was.

Producers: :func:`repro_torch.core.analysis.analyze_program` (program-level
facts: overflow, probe/static disagreement), the lint rules in
:class:`repro_torch.core.passes.ProgramAnalysisPass` (schedule-dependent rules:
quantized float-add exchange, mask/frontier mismatches), and
:func:`repro_torch.core.analysis.verify_ir` (structural IR invariants, code
family ``V*``).  They accumulate on ``PassContext.diagnostics`` and
surface as ``TranslationReport.diagnostics``.
"""
from __future__ import annotations

import dataclasses

__all__ = [
    "SEVERITIES",
    "DIAGNOSTIC_CODES",
    "Diagnostic",
    "max_severity",
    "render_table",
]

# Ordered weakest → strongest; ``strict`` translation rejects >= 'warning'.
SEVERITIES = ("info", "warning", "error")

# The stable code registry (docs/architecture.md reproduces this table).
# Analyzer/lint codes are ``A*``; IR-verifier invariant codes are ``V*``.
DIAGNOSTIC_CODES = {
    # -- analyzer / lint rules -------------------------------------------
    "A001": "gather/apply property decided by sampling probe only "
            "(the port has no static jaxpr tier)",
    "A002": "probe and static analysis disagree (soundness alarm: the "
            "conservative verdict is used)",
    "A003": "gather overflows the value dtype when evaluated at the "
            "program's init value (silent integer wrap at runtime)",
    "A004": "init value is the reduce's absorbing element: no superstep "
            "can ever change any vertex value",
    "A005": "mask_inactive=False with frontier='changed': inactive "
            "sources keep contributing messages while the frontier "
            "claims they are settled",
    "A006": "float 'add' reduce on a quantized multi-PE exchange: int8 "
            "wire rounding compounds per superstep and per PE",
    "A007": "no termination evidence: frontier='changed' with no "
            "max_iters and no monotone-convergence proof — only the "
            "superstep budget bounds the run",
    # -- IR verifier invariants ------------------------------------------
    "V001": "op multiplicity: duplicated or missing superstep ops",
    "V002": "op ordering: ops out of canonical superstep order",
    "V003": "reduce consistency: reduce op/identity disagrees with the "
            "program or its dtype",
    "V004": "gather module: annotation names no known menu module",
    "V005": "direction legality: push twin present without its "
            "preconditions (commutative reduce, identity masking, "
            "sparse frontier)",
    "V006": "backend/kernel agreement: kernel or push layout disagrees "
            "with the resolved backend",
    "V007": "exchange-plane consistency: collective/pes disagree with "
            "the reduce or the schedule plan",
    "V008": "frontier consistency: mode/dead flags disagree with the "
            "program's frontier semantics",
    "V009": "fused-superstep binding: pull_sweep/touched_free bound "
            "without their preconditions",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One structured finding: ``(code, severity, op, message, suggestion)``.

    ``code`` indexes :data:`DIAGNOSTIC_CODES`; ``op`` names the IR op or
    program element the finding anchors to (e.g. ``'gather'``,
    ``'apply'``, ``'Reduce'``); ``suggestion`` is the user-actionable fix
    (may be empty).
    """

    code: str
    severity: str                 # 'info' | 'warning' | 'error'
    op: str
    message: str
    suggestion: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity: {self.severity!r}")
        if self.code not in DIAGNOSTIC_CODES:
            raise ValueError(f"unregistered diagnostic code: {self.code!r}")

    def render(self) -> str:
        """One-line textual form (pass dumps, lint table rows)."""
        tail = f" [{self.suggestion}]" if self.suggestion else ""
        return f"{self.code} {self.severity} @{self.op}: {self.message}{tail}"


def max_severity(diagnostics) -> str | None:
    """Strongest severity present, or ``None`` for an empty sequence."""
    worst = None
    for d in diagnostics:
        if worst is None or SEVERITIES.index(d.severity) > \
                SEVERITIES.index(worst):
            worst = d.severity
    return worst


def render_table(diagnostics, *, title: str | None = None) -> str:
    """Aligned multi-line table of diagnostics (the lint CLI's output)."""
    rows = [(d.code, d.severity, d.op, d.message +
             (f" [{d.suggestion}]" if d.suggestion else ""))
            for d in diagnostics]
    if not rows:
        body = "(no diagnostics)"
    else:
        widths = [max(len(r[i]) for r in rows) for i in range(3)]
        body = "\n".join(
            f"{c:<{widths[0]}}  {s:<{widths[1]}}  {o:<{widths[2]}}  {m}"
            for c, s, o, m in rows)
    return f"{title}\n{body}" if title else body
