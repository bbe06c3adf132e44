#!/usr/bin/env python3
"""What the port's spans (``repro_torch.core.tracing``) cost under the
benchmark's profiler: a span's host time, and the device's idle share with
the spans on and off.

    python3 scripts/span_idle_ab.py <out.json> [--windows 6] [--run-steps 4]
        [--cells graph500-s21.bfs,graph500-s21-serve.mixed-c32]
        [--device cpu --scale 8]

* ``cost``: ns a pass of a loop that opens one span (or two, nested) with
  the profiler on, and one span site with it off, against the bare loop.
* each cell, as ``bench/run.py`` deploys it (same configuration, traffic
  and drivers): traced windows of ``--window`` seconds with the spans on
  and off interleaved inside each, so that the host's drift falls on both.
  The bfs cell alternates search by search (a key's searches alternate
  between the two); the serve cell alternates in runs of ``--run-steps``
  server steps under the closed-loop driver.  Busy is the union of the
  device's intervals clipped to each search or step, as
  ``bench/harness/trace.py`` takes it over the window; the idle share of
  each side is 1 − busy ÷ host time.  Prints a line a window and a
  summary a cell (on − off in points: each window's, their mean and
  standard error) and writes them all to ``<out.json>``.

The spans are switched off by replacing ``tracing.span`` with the no-op
it returns outside a profiler.
"""
import argparse
import bisect
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "bench" / "tests")]

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from bench.harness import cell, check, deploy, stats  # noqa: E402
from bench.harness import spans as spans_mod, trace as trace_mod  # noqa: E402
from bench.harness.spec import Spec  # noqa: E402
from repro_torch.core import tracing  # noqa: E402

REAL_SPAN = tracing.span


def off_span(name):
    return tracing._OFF


def per_pass_ns(body, n):
    t = time.perf_counter()
    body(n)
    return (time.perf_counter() - t) / n * 1e9


def bare(n):
    for _ in range(n):
        pass


def one(n):
    for _ in range(n):
        with tracing.span("run.read"):
            pass


def nested(n):
    for _ in range(n // 2):
        with tracing.span("lane.step"):
            with tracing.span("lane.read"):
                pass


def span_cost(dev, acts, reps=5):
    got = {"off_bare_ns": [], "off_span_ns": [], "on_bare_ns": [],
           "on_span_ns": [], "on_nested_ns_per_span": []}
    with profile(activities=acts):
        torch.ones(8, device=dev).sum().item()
    for _ in range(reps):
        got["off_bare_ns"].append(per_pass_ns(bare, 1_000_000))
        got["off_span_ns"].append(per_pass_ns(one, 1_000_000))
        with profile(activities=acts):
            got["on_bare_ns"].append(per_pass_ns(bare, 50_000))
            got["on_span_ns"].append(per_pass_ns(one, 50_000))
            got["on_nested_ns_per_span"].append(per_pass_ns(nested, 50_000))
    return {k: statistics.median(v) for k, v in got.items()}


def idle_by_side(prof):
    """Host seconds, device-busy seconds inside them and items, a side."""
    device, marks = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            if getattr(e, "is_user_annotation", False) or e.name.startswith(
                    ("bench.", "ab.", tracing.PREFIX)):
                continue        # a host range mirrored on the device
            device.append((e.time_range.start, e.time_range.end))
        elif e.name in ("ab.on", "ab.off"):
            marks.append((e.name[3:], e.time_range.start, e.time_range.end))
    busy = stats.union(device)
    starts = [b[0] for b in busy]
    sides = {m: {"host_s": 0.0, "busy_s": 0.0, "items": 0}
             for m in ("on", "off")}
    for side, s, e in marks:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        inside = 0.0
        while i < len(busy) and busy[i][0] < e:
            inside += max(0.0, min(e, busy[i][1]) - max(s, busy[i][0]))
            i += 1
        sides[side]["host_s"] += (e - s) * 1e-6
        sides[side]["busy_s"] += inside * 1e-6
        sides[side]["items"] += 1
    return _with_idle(sides)


def _with_idle(sides):
    for v in sides.values():
        v["idle"] = (100 * (1 - v["busy_s"] / v["host_s"])
                     if v["host_s"] else None)
    return sides


def bfs_window(drv, dev, acts, k, seconds):
    prog, keys = drv.prog, drv.keys
    n = len(keys)
    mark = torch._C._profiler._RecordFunctionFast
    deploy.sync(dev)
    with profile(activities=acts) as prof:
        i, t = 0, time.perf_counter()
        while time.perf_counter() - t < seconds:
            j = k * 100003 + i
            side = "on" if (j + j // n) % 2 == 0 else "off"
            tracing.span = REAL_SPAN if side == "on" else off_span
            with mark("ab." + side):
                prog.run(roots=keys[j % n])
                deploy.sync(dev)
            i += 1
        tracing.span = REAL_SPAN
    return prof


def serve_window(drv, dep, spans, dev, acts, seconds, run_steps, count):
    srv = dep.server
    step = type(srv).step
    mark = torch._C._profiler._RecordFunctionFast

    def stepped():
        side = "on" if (count[0] // run_steps) % 2 == 0 else "off"
        count[0] += 1
        tracing.span = REAL_SPAN if side == "on" else off_span
        try:
            with mark("ab." + side):
                return step(srv)
        finally:
            tracing.span = REAL_SPAN

    rec = cell.Record(num_vertices=dep.num_vertices, spans=spans)
    deploy.sync(dev)
    with profile(activities=acts) as prof:
        srv.step = stepped
        try:
            drv.window(seconds, spans, None, rec)
        finally:
            del srv.step
        deploy.sync(dev)
    drv.drain(30.0)
    return prof


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=None,
                    help="cut every configuration to this scale")
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--window", type=float, default=3.0)
    ap.add_argument("--run-steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=3400000003)
    ap.add_argument("--cells", default="graph500-s21.bfs,"
                    "graph500-s21-serve.mixed-c32")
    a = ap.parse_args()
    dev = torch.device(a.device)
    spec = Spec(ROOT)
    if a.scale:
        from conftest import tiny_copy
        spec = Spec(tiny_copy(Path(tempfile.mkdtemp()) / "c", a.scale))
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = {"device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "cost": span_cost(dev, acts)}
    print("cost", json.dumps(out["cost"]), flush=True)
    for w in a.cells.split(","):
        c = spec.workload(w)
        config = spec.config(c["config"])
        traffic = spec.traffic(c["traffic"])
        spans = spans_mod.Spans()
        dep = deploy.build(config, a.seed, dev, spans,
                           spec.generator(config["generator"]))
        sample = check.Sample(lambda kind: spec.kind(kind).SAMPLE, a.seed)
        drv = spec.driver(traffic["driver"])(dep, traffic, a.seed, spans,
                                             sample)
        trace_mod.Tracer(spans).warm(dev)
        windows, count = [], [0]
        for k in range(a.windows):
            lo = time.perf_counter()
            if dep.server is None:
                prof = bfs_window(drv, dev, acts, k, a.window)
            else:
                prof = serve_window(drv, dep, spans, dev, acts, a.window,
                                    a.run_steps, count)
            r = idle_by_side(prof)
            r["spans"] = len(tracing.records(lo, time.perf_counter()))
            windows.append(r)
            print(w, k, json.dumps(r), flush=True)
        diffs = [x["on"]["idle"] - x["off"]["idle"] for x in windows
                 if x["on"]["idle"] is not None
                 and x["off"]["idle"] is not None]
        pooled = _with_idle({m: {f: sum(x[m][f] for x in windows)
                                 for f in ("host_s", "busy_s", "items")}
                             for m in ("on", "off")})
        out[w] = {"windows": windows, "pooled": pooled,
                  "on_minus_off": diffs,
                  "mean": statistics.fmean(diffs) if diffs else None,
                  "standard_error": (statistics.stdev(diffs)
                                     / len(diffs) ** 0.5
                                     if len(diffs) > 1 else None)}
        print(w, json.dumps({k: v for k, v in out[w].items()
                             if k != "windows"}), flush=True)
        del drv, sample
        deploy.release(dep)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
