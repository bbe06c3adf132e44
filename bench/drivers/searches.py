"""Graph500 kernel 2: back-to-back BFS searches on a resident graph.

Traffic: ``{"driver": "searches", "keys": <n>}``.  The driver draws
``keys`` distinct search keys from the seed among the vertices of degree
at least one (self-loops aside), translates ``dsl.bfs_program`` once
(set-up), runs a search from every key once to warm up, and in the
window cycles the keys back to back through the one program's ``run``.
Every search of the window is offered to the check's sample as a
``bfs`` answer.
"""
from __future__ import annotations

import time

import numpy as np

from bench.harness import deploy
from bench.harness.check import Answer
from bench.reference.bfs import UNREACHED


class Driver:
    def __init__(self, dep: deploy.Deployment, traffic: dict, seed: int,
                 spans, sample):
        from repro_torch.core import dsl
        from repro_torch.core.translator import translate
        self.dep, self.sample = dep, sample
        rng = np.random.default_rng(int(seed) % (1 << 64))
        cand = np.flatnonzero(dep.degree > 0)
        self.keys = [int(r) for r in rng.choice(
            cand, min(int(traffic["keys"]), cand.size), replace=False)]
        self.edges = [int(dep.vertex_tuples[r]) for r in self.keys]
        with spans.span("translate"):
            self.prog = translate(dsl.bfs_program(UNREACHED), dep.graph,
                                  deploy.schedule(dep.config["engine"]),
                                  device=dep.device)
        for r in self.keys:                 # every search once
            with spans.span("run"):
                self.prog.run(roots=r)
                deploy.sync(dep.device)

    def programs(self):
        return [self.prog]

    def window(self, seconds: float, spans, tracer, rec) -> None:
        dev, prog, keys = self.dep.device, self.prog, self.keys
        i = 0
        t0 = end = time.perf_counter()
        while end - t0 < seconds:
            if tracer is not None and tracer.due(end - t0, seconds):
                tracer.start(dev)
            root = keys[i % len(keys)]
            a = time.perf_counter()
            with spans.span("run"):
                levels, _ = prog.run(roots=root)
                deploy.sync(dev)
            end = time.perf_counter()
            st = prog.last_run_stats
            rec.searches.append({
                "root": root, "edges": self.edges[i % len(keys)],
                "ms": 1e3 * (end - a),
                "supersteps": st["push_supersteps"] + st["pull_supersteps"],
                "traced": tracer is not None and tracer.active})
            self.sample.offer(
                "bfs", lambda: Answer("bfs", root, levels.clone()))
            i += 1
        rec.window_s = end - t0
        if tracer is not None and tracer.active:
            tracer.stop(dev)
        rec.attempted = i

    def drain(self, grace_s: float) -> int:
        """Searches left without an answer: a search returns or raises."""
        return 0
