"""Closed-loop clients on a ``GraphServer``: each client sends its next
query the moment its last is answered.

Traffic: ``{"driver": "closed_loop", "clients": <n>, "pattern": [kinds],
"ppr_roots": <n>}``.  Query ``i`` is of kind ``pattern[i % len]``; bfs,
sssp and dist roots and dist targets are drawn from the seed, in the
order the queries are sent, uniformly over the vertices of degree at
least one (self-loops aside); ppr roots from a fixed set of
``ppr_roots`` such vertices.  In set-up every ppr root's program is
translated and a burst of ``WARMUP_QUERIES`` of the mix, from roots of
its own, is served and drained.  The window drives ``submit`` and
``step``; every exact answer is offered to the check's sample.
"""
from __future__ import annotations

import time

import numpy as np

from bench.harness import deploy
from bench.harness.check import Answer

WARMUP_QUERIES = 64


class Driver:
    def __init__(self, dep: deploy.Deployment, traffic: dict, seed: int,
                 spans, sample):
        if dep.server is None:
            raise ValueError("closed_loop traffic needs a configuration "
                             "that deploys a server")
        self.dep, self.sample = dep, sample
        self.clients = int(traffic["clients"])
        self.pattern = list(traffic["pattern"])
        self.rng = np.random.default_rng(int(seed) % (1 << 64))
        self.cand = np.flatnonzero(dep.degree > 0)
        self.ppr_roots = self.rng.choice(
            self.cand, int(traffic["ppr_roots"]), replace=False)
        # warm-up, in set-up: every ppr root's program, then a burst of
        # the mix, drained
        srv = dep.server
        for r in self.ppr_roots:
            srv.submit("ppr", int(r))
        for i in range(WARMUP_QUERIES):
            kind, root, target = self._draw(i)
            srv.submit(kind, root, target=target)
        srv.run()
        deploy.sync(dep.device)
        self.out: list = []
        self.next = 0

    def programs(self):
        return list(self.dep.server._programs.values())

    def _draw(self, idx: int):
        """``(kind, root, target)`` of query ``idx``, the next draws."""
        kind = self.pattern[idx % len(self.pattern)]
        if kind == "ppr":
            return kind, int(self.ppr_roots[self.rng.integers(
                len(self.ppr_roots))]), None
        root = int(self.cand[self.rng.integers(self.cand.size)])
        if kind != "dist":
            return kind, root, None
        return kind, root, int(self.cand[self.rng.integers(self.cand.size)])

    def _send(self, c: int, spans) -> None:
        idx = self.next
        self.next += 1
        kind, root, target = self._draw(idx)
        sent = time.perf_counter()
        with spans.span("submit"):
            q = self.dep.server.submit(kind, root, target=target)
        self.out[c] = (q, sent)

    def _offer(self, q) -> None:
        """Offer the answer to the sample, then drop it from the handle."""
        result = q.result
        self.sample.offer(q.kind, lambda: Answer(q.kind, q.root, result,
                                                 q.target), q.iters)
        q.result = None

    def window(self, seconds: float, spans, tracer, rec) -> None:
        srv, dev = self.dep.server, self.dep.device
        self.out = [None] * self.clients
        c0 = srv.counters()
        t0 = time.perf_counter()
        for c in range(self.clients):
            self._send(c, spans)
        while True:
            now = time.perf_counter()
            if now - t0 >= seconds:
                break
            if tracer is not None and tracer.due(now - t0, seconds):
                tracer.start(dev)
            with spans.span("step"):
                srv.step()
            for c in range(self.clients):
                q, sent = self.out[c]
                while q.done:
                    at = time.perf_counter()
                    exact = q.answer_quality == "exact"
                    rec.queries.append({
                        "kind": q.kind, "ms": 1e3 * (at - sent),
                        "served_by": q.served_by, "at": at,
                        "exact": exact})
                    if exact:
                        self._offer(q)
                    self._send(c, spans)
                    q, sent = self.out[c]
        rec.window_s = now - t0
        c1 = srv.counters()
        rec.counters = {k: c1[k] - c0[k] for k in c1}
        if tracer is not None and tracer.active:
            tracer.stop(dev)
        rec.attempted = self.next
        rec.inexact = sum(not q["exact"] for q in rec.queries)

    def drain(self, grace_s: float) -> int:
        """Step until every query sent in the window is answered or the
        grace period is over; the number left with no exact answer."""
        srv = self.dep.server
        end = time.perf_counter() + grace_s
        while any(not q.done for q, _ in self.out) \
                and time.perf_counter() < end:
            srv.step()
        left = 0
        for q, _ in self.out:
            if q.done and q.answer_quality == "exact":
                self._offer(q)
            else:
                left += 1
        return left
