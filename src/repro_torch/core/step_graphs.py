"""The run loop's supersteps as CUDA graphs, one graph a route.

On a single-PE plan whose pull plane is the dense sweep, on CUDA,
:meth:`~repro_torch.core.translator.CompiledGraphProgram.run` enqueues
each superstep as one replay of a CUDA graph in place of its dozen or
more launches from Python, and reads the next occupancy from pinned host
memory that the graph itself wrote.  The translator decides from the
plan whether a program takes this path; every other plan keeps the eager
loop (:class:`EagerSteps`).

A route is one way a superstep runs: ``"pull"`` (the dense sweep), or
``("push", t)``, the compacted push at capacity tier ``t``, where ``t ==
len(tiers)`` is the push plane's dense fallback (kernel 1) and a push
without tiers (the chunked scatter) has the one route ``("push", 0)``.
The host still makes every decision it made: the direction, the tier,
the fallback and the exit test.  Each decision names the graph to replay.

Each route's graph

1. reads the loop's static ``(values, active)`` buffers;
2. runs the eager superstep unchanged (the same kernels, dtypes and
   tiers), with the NaN probe where the run has one;
3. copies the next ``(values, active)`` back into the static buffers;
4. sums the next frontier's occupancy (``m_f``, ``n_f``, the live
   forward-ELL rows and any pull counters left on the device) into one
   small int64 vector;
5. copies that vector into a pinned host buffer of its own.

A read is then a wait on an event recorded behind the replay and a read
of that buffer.  One more graph, :data:`READ`, is the occupancy read
alone, of the state a run starts from.

Every route is captured at a program's first run, after one eager
warm-up on a side stream, into graphs that share one memory pool: one
replays at a time, in stream order, and none hands a tensor to another
(each reads and writes only the static buffers and its own host buffer).
The kernel wrappers' launch counters (``edge_block_reduce.launches`` and
the like) are bumped in Python, so a replay adds the counts its capture
made; the warm-ups' and captures' own counts are taken back, and the
counters grow by what the eager loop would launch.
"""
from __future__ import annotations

import torch

from .. import kernels

__all__ = ["READ", "EagerSteps", "GraphSteps"]

READ = "read"       # the route that reads the occupancy alone


class EagerSteps:
    """The run loop's supersteps enqueued op by op from Python, each
    occupancy read a blocking ``.tolist()``."""

    def __init__(self, prog, values, active):
        self._prog = prog
        self.values, self._active = values, active
        self._pending = ()      # the last pull superstep's counters
        self._probe = prog._probe and values.dtype.is_floating_point

    def read(self):
        """``(m_f, n_f, r_f, pull_stats)`` of the current frontier."""
        out = self._prog._occupancy(self._active, self._pending)
        self._pending = ()
        return out

    def push(self, r_f):
        self.values, self._active, _ = self._prog._push_step(
            self.values, self._active, r_f)
        self._freeze_on_nan()

    def pull(self, m_f):
        self.values, self._active, self._pending = self._prog._pull_step(
            self.values, self._active, m_f)
        self._freeze_on_nan()

    def _freeze_on_nan(self):
        if self._probe:
            # a NaN anywhere freezes the frontier: the loop exits next
            # superstep and the run reads terminated='diverged'
            self._active = self._active & ~torch.isnan(self.values).any()

    def result(self):
        return self.values


class GraphSteps:
    """A program's route graphs, its static state and its host buffers.

    :meth:`start` begins a run (capturing every route at the program's
    first run), :meth:`push` and :meth:`pull` replay a superstep's
    graph, :meth:`read` waits for the last replay and decodes its host
    buffer, :meth:`result` copies the final values out.  ``replays``
    counts every replay since construction.
    """

    def __init__(self, prog):
        self._prog = prog
        # route → (graph, launch counts a replay adds, the pull counters'
        # template: Python ints, or tensors read from the host buffer,
        # pinned host buffer)
        self._graphs: dict = {}
        self._last = READ
        self._done = None           # the event a read waits on
        self._stream = None         # the stream of the run's replays
        self.values = self.active = None
        self.replays = 0

    def _routes(self) -> list:
        prog = self._prog
        routes = [READ]
        if prog._mode != "push":
            routes.append("pull")
        if prog._mode != "pull":
            tiers = prog._push_tiers
            routes += [("push", t) for t in
                       range(1 if tiers is None else len(tiers) + 1)]
        return routes

    def _body(self, route):
        """The work a route's graph holds: a function of the route's
        pinned host buffer (``None`` at the warm-up, which copies nothing
        out) that returns the pull counters' template and the occupancy
        vector."""
        prog = self._prog
        probe = prog._probe and self.values.dtype.is_floating_point
        rows = prog._route_rows(route[1]) if isinstance(route, tuple) \
            else None

        def body(host=None):
            pending = ()
            if route != READ:
                if rows is None:
                    new, nxt, pending = prog._pull_step(self.values,
                                                        self.active)
                else:
                    new, nxt, _ = prog._push_step(self.values, self.active,
                                                  rows)
                if probe:
                    nxt = nxt & ~torch.isnan(new).any()
                self.values.copy_(new)
                self.active.copy_(nxt)
            vec = prog._occupancy_vector(self.active, pending)
            if host is not None:
                host.copy_(vec, non_blocking=True)
            return pending, vec

        return body

    def _capture(self) -> int:
        """Capture every route; returns the graphs captured.  The static
        buffers hold a valid state on entry (the warm-ups step it)."""
        counts = kernels.launch_counts()
        pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream()
        graphs = {}
        try:
            for route in self._routes():
                body = self._body(route)
                side.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(side):
                    _, vec = body()
                torch.cuda.current_stream().wait_stream(side)
                host = torch.empty(vec.shape, dtype=vec.dtype,
                                   pin_memory=True)
                before = kernels.launch_counts()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool):
                    pending, _ = body(host)
                after = kernels.launch_counts()
                delta = {k: n - before.get(k, 0) for k, n in after.items()
                         if n != before.get(k, 0)}
                graphs[route] = (graph, delta, pending, host)
        finally:
            kernels.set_launch_counts(counts)
        self._graphs, self._done = graphs, torch.cuda.Event()
        return len(graphs)

    def start(self, roots, values) -> int:
        """Write a run's initial state into the static buffers and replay
        the read; captures every route first at the program's first run.
        Returns the graphs captured."""
        prog = self._prog
        captured = 0
        if not self._graphs:
            self.values, self.active = (
                t.clone() for t in prog.init_state(roots=roots, values=values))
            captured = self._capture()
        prog.init_state(roots=roots, values=values,
                        out=(self.values, self.active))
        self._stream = torch.cuda.current_stream()
        self._replay(READ)
        return captured

    def _replay(self, route):
        graph, delta, _, _ = self._graphs[route]
        graph.replay()
        kernels.add_launch_counts(delta)
        self._last = route
        self.replays += 1

    def read(self):
        """``(m_f, n_f, r_f, pull_stats)`` of the last replay's frontier:
        waits on an event behind it, then decodes its host buffer."""
        _, _, pending, host = self._graphs[self._last]
        self._done.record(self._stream)
        self._done.synchronize()
        return self._prog._decode_occupancy(host.tolist(), pending)

    def push(self, r_f):
        self._replay(("push", self._prog._push_route(r_f)))

    def pull(self, m_f):
        self._replay("pull")

    def result(self):
        """The final values, a copy the caller owns."""
        return self.values.clone()
