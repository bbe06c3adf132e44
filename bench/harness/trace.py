"""The device trace of a measured window, reduced to what the metrics read.

``torch.profiler`` records the host's operations and the device's
kernels, copies and fills over the last ``SECONDS`` of the window.  The
busy time is the union of the device's intervals (overlapping kernels
count once; copies and fills count), the idle gaps are what that union
leaves of the traced window, and each gap is named by the benchmark
span the host was in at its middle.
"""
from __future__ import annotations

import collections
import dataclasses
import time

from . import stats

WINDOW = "bench.window"
TOP = 10
SECONDS = 3.0               # the traced stretch at the end of a window


@dataclasses.dataclass
class TraceSummary:
    window_s: float                       # the traced window's length
    busy_s: float                         # union of device intervals in it
    start: float                          # host clock at the window's start
    end: float                            # and at its end
    device_ops: list                      # [[name, seconds], ...]
    idle_gaps: list                       # [[span name, seconds], ...]

    @property
    def idle_percent(self) -> float | None:
        if self.window_s <= 0 or self.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def summarize(events, window: tuple[float, float], host_window,
              top: int = TOP) -> TraceSummary:
    """Reduce trace events to a :class:`TraceSummary`.

    ``events`` are ``(name, on_device, start, end)`` in one time base
    (the profiler's microseconds); ``window`` is the traced window in
    that base and ``host_window`` the same window on the host clock.
    """
    lo, hi = window
    device = [(s, e) for name, dev, s, e in events if dev]
    busy = stats.union(stats.clip(device, lo, hi))
    busy_us = sum(b - a for a, b in busy)
    by_op: dict = collections.defaultdict(float)
    for name, dev, s, e in events:
        if dev and min(e, hi) > max(s, lo):
            by_op[_short(name)] += (min(e, hi) - max(s, lo)) * 1e-6
    spans = [(name[len("bench."):], s, e) for name, dev, s, e in events
             if not dev and name.startswith("bench.") and name != WINDOW]
    by_span: dict = collections.defaultdict(float)
    for a, b in stats.gaps(busy, lo, hi):
        mid = 0.5 * (a + b)
        inside = [(e - s, n) for n, s, e in spans if s <= mid <= e]
        by_span[min(inside)[1] if inside else "harness"] += (b - a) * 1e-6
    return TraceSummary(
        window_s=(hi - lo) * 1e-6, busy_s=busy_us * 1e-6,
        start=host_window[0], end=host_window[1],
        device_ops=[[n, s] for n, s in sorted(
            by_op.items(), key=lambda kv: -kv[1])[:top]],
        idle_gaps=[[n, s] for n, s in sorted(
            by_span.items(), key=lambda kv: -kv[1])[:top]])


def _short(name: str, limit: int = 100) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    argument list, at most ``limit`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    cut = name.find("(")
    name = name[:cut] if cut > 0 else name
    return name[:limit]


class Tracer:
    """Profiles one stretch of a window; :meth:`summary` reduces it."""

    def __init__(self, spans):
        self.spans = spans
        self.active = False
        self.summary: TraceSummary | None = None
        self._prof = None
        self._range = None
        self._host = None

    def warm(self, device) -> None:
        """Start and stop the profiler once, in set-up, so that its own
        start-up does not fall inside the window."""
        import torch
        from torch.profiler import profile
        with profile(activities=_activities(device)):
            torch.ones(8, device=device).sum().item()

    def due(self, elapsed: float, seconds: float) -> bool:
        """Whether to start, ``elapsed`` seconds into a window of
        ``seconds``: once, for the window's last ``SECONDS``."""
        return (self.summary is None and not self.active
                and elapsed >= seconds - min(SECONDS, seconds))

    def start(self, device) -> None:
        from torch.profiler import profile, record_function
        _sync(device)
        self._prof = profile(activities=_activities(device))
        self._prof.__enter__()
        self._range = record_function(WINDOW)
        self._range.__enter__()
        self._host = time.perf_counter()
        self.spans.traced = True
        self.active = True

    def stop(self, device) -> None:
        from torch.autograd import DeviceType
        _sync(device)
        end = time.perf_counter()
        self.spans.traced = False
        self.active = False
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        events = []
        window = None
        for e in self._prof.events():
            if e.device_type != DeviceType.CPU and (
                    getattr(e, "is_user_annotation", False)
                    or e.name.startswith("bench.")):
                continue        # a host range mirrored on the device
            dev = e.device_type != DeviceType.CPU
            item = (e.name, dev, e.time_range.start, e.time_range.end)
            if e.name == WINDOW and not dev:
                window = (item[2], item[3])
            events.append(item)
        self._prof = None
        self.summary = summarize(events, window, (self._host, end))


def _activities(device):
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
