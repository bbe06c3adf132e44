"""Deterministic fault-injection registry for the execution layer.

Counterpart of ``repro.core.faults``, the same registry under the same
names.  The production code is instrumented with *named injection
points*: cheap :func:`trip` calls that are no-ops until a test arms them.
Arming is deterministic: a point fires for an exact number of trips
(``times``), optionally skipping the first ``after`` calls, or
probabilistically under a *seeded* PRNG (``rate``/``seed``) so a chaos
run replays bit-identically.

Registered points (all six are registered; this package trips five of
them, ``comm.collective`` belongs to the multi-PE plane, not ported yet):

========================  ====================================================
point                     trips in
========================  ====================================================
``prefetch.device_put``   ``core/stream.py`` — before a partition's copy to
                          the device (inside the fetch retry ladder)
``container.read``        ``data/graphs.py`` — between a partition's read
                          and its CRC32 check (``mode='corrupt'`` flips it)
``lane.superstep``        ``core/translator.py`` ``run_batch_slice`` — before
                          a budget slice executes; ``core/stream.py`` —
                          before each streamed superstep
``comm.collective``       the multi-PE exchange (not ported yet)
``checkpoint.write``      ``core/checkpoint.py`` — before a snapshot's
                          temp files are renamed into place (models a crash
                          mid-write; the atomic rename means a half-written
                          snapshot is never visible under its final name)
``lane.crash``            ``core/translator.py`` / ``serve/graph_serve.py`` —
                          at the slice boundaries of checkpointed runs and
                          of the server's step; ``core/stream.py`` — at
                          each superstep and partition boundary (models a
                          process crash; the caller catches it,
                          re-translates fresh, and resumes from the last
                          durable snapshot)
========================  ====================================================

Raise-mode faults raise :class:`repro_torch.errors.InjectedFault` (a
:class:`~repro_torch.errors.TransientFault`), so the production retry paths
handle them exactly like real transient failures.  Corrupt-mode faults
perturb the payload passed through :func:`trip` and return it; the
consumer's integrity check (CRC32) is expected to catch the damage.

Usage::

    from repro_torch.core import faults
    with faults.injected("lane.crash", times=1, after=2) as plan:
        try:                       # the third slice boundary "crashes"
            prog.run(roots=0, checkpoint_dir=ck)
        except InjectedFault:
            pass
    assert plan.fired == 1
    prog.run(roots=0, checkpoint_dir=ck, resume=True)   # resumes exactly
"""
from __future__ import annotations

import contextlib
import dataclasses
import random

import numpy as np

from ..errors import InjectedFault

__all__ = [
    "INJECTION_POINTS",
    "FaultPlan",
    "arm",
    "disarm",
    "reset",
    "trip",
    "fired",
    "calls",
    "active",
    "injected",
]

INJECTION_POINTS = (
    "prefetch.device_put",
    "container.read",
    "lane.superstep",
    "comm.collective",
    "checkpoint.write",
    "lane.crash",
)


@dataclasses.dataclass
class FaultPlan:
    """One armed injection point: when it fires and what it does."""

    point: str
    mode: str = "raise"          # 'raise' | 'corrupt'
    times: int = 1               # fire at most this many trips (<0: unlimited)
    after: int = 0               # skip the first `after` trips
    rate: float | None = None    # fire each eligible trip with this seeded
    seed: int = 0                # probability (None: fire every eligible trip)
    exc: type = InjectedFault
    calls: int = 0               # trips seen
    fired: int = 0               # trips that actually faulted

    def __post_init__(self) -> None:
        if self.point not in INJECTION_POINTS:
            raise ValueError(
                f"unknown injection point {self.point!r}; "
                f"registered: {', '.join(INJECTION_POINTS)}")
        if self.mode not in ("raise", "corrupt"):
            raise ValueError(f"mode must be 'raise' or 'corrupt', "
                             f"got {self.mode!r}")
        if self.rate is not None and not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        self._rng = random.Random(self.seed)

    def should_fire(self) -> bool:
        """Advance the call counter; True iff this trip faults."""
        self.calls += 1
        if self.calls <= self.after:
            return False
        if self.times >= 0 and self.fired >= self.times:
            return False
        if self.rate is not None and self._rng.random() >= self.rate:
            return False
        self.fired += 1
        return True


_ARMED: dict[str, FaultPlan] = {}


def arm(point: str, *, mode: str = "raise", times: int = 1, after: int = 0,
        rate: float | None = None, seed: int = 0,
        exc: type = InjectedFault) -> FaultPlan:
    """Arm ``point``; returns the live :class:`FaultPlan` (counters on it)."""
    plan = FaultPlan(point, mode=mode, times=times, after=after, rate=rate,
                     seed=seed, exc=exc)
    _ARMED[point] = plan
    return plan


def disarm(point: str | None = None) -> None:
    """Disarm one point, or every point when ``point`` is None."""
    if point is None:
        _ARMED.clear()
    else:
        _ARMED.pop(point, None)


def reset() -> None:
    """Disarm everything (test-teardown hook)."""
    _ARMED.clear()


def fired(point: str) -> int:
    """How many times ``point`` actually faulted (0 if never armed)."""
    plan = _ARMED.get(point)
    return plan.fired if plan is not None else 0


def calls(point: str) -> int:
    """How many times ``point`` was tripped (0 if never armed)."""
    plan = _ARMED.get(point)
    return plan.calls if plan is not None else 0


def active() -> tuple[str, ...]:
    """Currently-armed point names."""
    return tuple(_ARMED)


def trip(point: str, payload=None):
    """Production-side hook: no-op unless ``point`` is armed.

    Raise-mode: raises the plan's exception class.  Corrupt-mode: returns
    a deterministically damaged copy of ``payload`` (a dict of numpy
    arrays); otherwise returns ``payload`` unchanged.
    """
    plan = _ARMED.get(point)
    if plan is None or not plan.should_fire():
        return payload
    if plan.mode == "corrupt":
        return _corrupt(payload, plan.seed + plan.fired)
    raise plan.exc(f"injected fault at {point} (trip #{plan.fired})")


def _corrupt(payload, seed: int):
    """Flip one element in the largest integer array of ``payload``.

    ``payload`` is a dict of numpy arrays (the partition members a
    ``container.read`` fetch just produced).  The damage is deterministic
    given the seed and guaranteed to change the bytes a CRC32 covers.
    """
    if not isinstance(payload, dict):
        raise TypeError("corrupt-mode trip needs a dict-of-arrays payload")
    out = {k: (np.array(v, copy=True) if isinstance(v, np.ndarray) else v)
           for k, v in payload.items()}
    candidates = [k for k, v in out.items()
                  if isinstance(v, np.ndarray) and v.size > 0]
    if not candidates:
        return out
    # prefer the destination column: always present, always checksummed
    key = "dst" if "dst" in candidates else max(
        candidates, key=lambda k: out[k].nbytes)
    arr = out[key]
    idx = random.Random(seed).randrange(arr.size)
    flat = arr.reshape(-1)
    if np.issubdtype(arr.dtype, np.integer):
        flat[idx] ^= 1
    else:
        flat[idx] = flat[idx] + 1.0 if np.isfinite(flat[idx]) else 0.0
    return out


@contextlib.contextmanager
def injected(point: str, **kwargs):
    """Arm ``point`` for the enclosed block, disarming on exit.

    Yields the :class:`FaultPlan` so the block can assert on ``fired``.
    """
    plan = arm(point, **kwargs)
    try:
        yield plan
    finally:
        disarm(point)
