"""One run of one cell: set-up, the measured window, the check, the line.

The order matters: the window closes, the device's peak is read, the
modules loaded are looked at, the program is released, and only then do
the references run on the card, so that they set no peak and take no
time of the window.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import torch

from . import check, deploy, spans as spans_mod, trace as trace_mod
from .spec import Spec

# top-level module names that may not be loaded in a run: JAX and the
# JAX package this port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# how long past the window's close a query sent in it may take
GRACE_S = 60.0


@dataclasses.dataclass
class Record:
    """What a run measured; each metric's reader takes what it needs."""
    num_vertices: int
    spans: spans_mod.Spans
    setup_s: float | None = None
    window_s: float | None = None
    attempted: int = 0
    inexact: int = 0
    searches: list = dataclasses.field(default_factory=list)
    queries: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    device_peak_bytes: int | None = None
    layouts_s: float | None = None
    translate_s: float | None = None
    trace: trace_mod.TraceSummary | None = None
    device_kind: str = ""


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def _refuse_forbidden() -> None:
    loaded = forbidden_modules()
    if loaded:
        raise RuntimeError(f"forbidden modules loaded: {loaded}")


def translate_s(programs) -> float:
    """Translation seconds outside the layouts' build and their copy to
    the device, summed over ``programs``."""
    keys = ("passes_s", "analysis_s", "build_s", "emit_s")
    return sum(sum(p.report.translate_breakdown[k] for k in keys)
               for p in programs)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", started: float | None = None, spec: Spec | None = None,
        with_control: bool = False) -> dict:
    """Run ``workload`` once; returns the result line's object (and, with
    ``with_control``, the control's numbers under ``"control"``).

    Raises ``RuntimeError`` when a forbidden module is loaded.
    """
    started = time.perf_counter() if started is None else started
    spec = spec or Spec()
    device = torch.device(device)
    cell = spec.workload(workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    spans = spans_mod.Spans()
    tracer = trace_mod.Tracer(spans) if trace else None
    dep = deploy.build(config, seed, device, spans,
                       spec.generator(config["generator"]))
    sample = check.Sample(lambda kind: spec.kind(kind).SAMPLE, seed)
    driver = spec.driver(traffic["driver"])(dep, traffic, seed, spans,
                                            sample)
    if tracer is not None:
        tracer.warm(device)
    rec = Record(num_vertices=dep.num_vertices,
                 spans=spans,
                 device_kind=(torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"))
    deploy.sync(device)
    rec.setup_s = time.perf_counter() - started

    driver.window(seconds, spans, tracer, rec)

    program_peak = (torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else None)
    rec.device_peak_bytes = program_peak
    unanswered = driver.drain(GRACE_S) + rec.inexact
    rec.trace = tracer.summary if tracer is not None else None
    rec.layouts_s = deploy.layouts_s()
    rec.translate_s = translate_s(driver.programs())
    _refuse_forbidden()

    answers = sample.answers()
    del driver, sample
    deploy.release(dep)
    refs = check.References(dep.edges_on(device), dep.num_vertices,
                            config["engine"].get("server"), spec.kind)
    read = check.readings(answers, refs)
    found = check.numbers(read)
    found["unanswered"] = unanswered
    limits = config["limits"]
    correct, checks = check.judge(found, limits)
    wrong = sum(limits.get(kind.NUMBER) is None
                or value > limits[kind.NUMBER] for kind, value in read)
    control = check.control(answers, refs) if with_control else None
    del refs, answers
    if device.type == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    for m in spec.metrics(workload, trace):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": rec.device_kind, "count": int(cell["chips"]),
           "memory_peak_bytes": max(dep.bench_peak_bytes,
                                    program_peak or 0)}
    result = {"correct": correct, "attempted": rec.attempted,
              "failed": unanswered + wrong,
              "metrics": metrics, "device": dev}
    if rec.trace is not None:
        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.device_ops,
                               "idle_gaps": rec.trace.idle_gaps}
    _refuse_forbidden()
    if control is not None:
        result["control"] = control
    result["checks"] = checks           # last: the numbers and limits
    return result
