"""Typed exception hierarchy for the fault-tolerant execution layer.

Every failure the runtime can *diagnose* raises a subclass of
:class:`ReproError`, so callers can catch the whole family with one
``except`` clause or back off programmatically on a specific class
(:class:`QueueFull` carries ``pending``/``max_queue`` for exactly that).

Back-compat note: classes that replace earlier bare ``ValueError`` /
``RuntimeError`` raises (:class:`InvalidQuery`, :class:`GraphValidationError`,
:class:`QueueFull`) multiply-inherit from the original builtin type, so
pre-existing ``except ValueError`` / ``except RuntimeError`` handlers keep
working.
"""
from __future__ import annotations

__all__ = [
    "ReproError",
    "GraphValidationError",
    "ChecksumError",
    "TransientFault",
    "InjectedFault",
    "StreamRetryError",
    "InvalidQuery",
    "QueueFull",
    "DiagnosticError",
    "IRVerificationError",
    "CheckpointError",
    "CheckpointCorruptError",
    "CheckpointMismatchError",
]


class ReproError(Exception):
    """Base class for every diagnosed runtime failure in this framework."""


class GraphValidationError(ReproError, ValueError):
    """A graph (or program/graph pairing) failed structural validation.

    Raised by :func:`repro_torch.core.graph.validate_graph` — monotone-offset,
    in-range destination, and per-reduce weight-domain checks.  Subclasses
    ``ValueError`` so callers treating malformed inputs generically keep
    working.
    """


class ChecksumError(ReproError):
    """A partition's payload did not match its stored CRC32 checksum.

    Raised by the partition container reader
    (:class:`repro_torch.data.graphs.PartitionContainer`) when a
    streamed fetch reads bytes whose checksum disagrees with the one
    recorded at container-build time.  The streaming layer evicts and
    re-reads once (transient corruption — a torn read, a poisoned cache
    entry) before letting this propagate.
    """

    def __init__(self, message: str, *, partition: int | None = None):
        super().__init__(message)
        self.partition = partition


class TransientFault(ReproError):
    """A failure the streaming layer may retry with bounded backoff."""


class InjectedFault(TransientFault):
    """The deterministic failure raised by armed ``core/faults.py`` points.

    Subclasses :class:`TransientFault` so the production retry paths treat
    an injected fault exactly like a real transient one — the chaos suite
    exercises the *same* recovery code that ships.
    """


class StreamRetryError(ReproError):
    """Bounded retries of a partition fetch/transfer were exhausted.

    Carries ``partition`` and ``attempts`` so stats/telemetry can report
    where the stream gave up; the original cause rides ``__cause__``.
    """

    def __init__(self, message: str, *, partition: int | None = None,
                 attempts: int = 0):
        super().__init__(message)
        self.partition = partition
        self.attempts = attempts


class InvalidQuery(ReproError, ValueError):
    """A serving-plane query was malformed (kind/root/target out of range).

    Subclasses ``ValueError`` — the pre-typed serving API raised bare
    ``ValueError`` for these, and existing handlers keep working.
    """


class DiagnosticError(ReproError):
    """Strict translation rejected a program over lint findings.

    Raised by ``translate(..., strict=True)`` when the pass pipeline's
    structured diagnostics contain any warning- or error-severity entry.
    ``diagnostics`` carries the full tuple of
    :class:`repro_torch.core.diagnostics.Diagnostic` so callers can render or
    filter them programmatically.
    """

    def __init__(self, message: str, *, diagnostics: tuple = ()):
        super().__init__(message)
        self.diagnostics = tuple(diagnostics)


class IRVerificationError(ReproError):
    """The IR verifier found a broken structural invariant between passes.

    Raised by ``PassPipeline.run(..., verify=True)`` the moment a pass
    produces an IR violating :func:`repro_torch.core.analysis.verify_ir`'s
    invariants — at the offending pass boundary, not as wrong numerics
    three layers down.  ``stage`` names the boundary (e.g. ``"after
    backend-selection"``); ``diagnostics`` carries the typed ``V*``
    findings naming each violated invariant.
    """

    def __init__(self, message: str, *, stage: str = "",
                 diagnostics: tuple = ()):
        super().__init__(message)
        self.stage = stage
        self.diagnostics = tuple(diagnostics)


class CheckpointError(ReproError):
    """Base class for checkpoint/restore failures.

    A checkpoint problem is never silently absorbed: a snapshot that can't
    be trusted (corrupt, truncated, or taken against different inputs)
    must surface as a typed error rather than resume into wrong numerics.
    """


class CheckpointCorruptError(CheckpointError):
    """A snapshot file is unreadable, truncated, or fails its CRC32s.

    ``path`` names the offending file; ``member`` the manifest entry or
    array whose integrity check failed (empty when the container itself
    is unreadable).
    """

    def __init__(self, message: str, *, path: str = "", member: str = ""):
        super().__init__(message)
        self.path = path
        self.member = member


class CheckpointMismatchError(CheckpointError):
    """A snapshot was taken against a different graph/program/schedule.

    Restoring lane state onto mismatched inputs would produce silently
    wrong answers, so every restore re-derives the fingerprints and
    compares them to the manifest.  ``field`` names the first mismatching
    fingerprint (``"graph"``, ``"program"``, ``"schedule"``, or a format
    field like ``"version"``/``"kind"``); ``expected``/``got`` carry the
    two fingerprint strings.
    """

    def __init__(self, message: str, *, field: str = "",
                 expected: str = "", got: str = ""):
        super().__init__(message)
        self.field = field
        self.expected = expected
        self.got = got


class QueueFull(ReproError, RuntimeError):
    """Serving-plane back-pressure: the admission queue is at capacity.

    ``pending`` is the number of queries in flight when the submit was
    rejected; ``max_queue`` is the configured admission bound.  Subclasses
    ``RuntimeError`` for back-compat with the pre-typed raise.
    """

    def __init__(self, message: str, *, pending: int = 0, max_queue: int = 0):
        super().__init__(message)
        self.pending = pending
        self.max_queue = max_queue
