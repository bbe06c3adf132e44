"""Serving: prefill + decode steps and a continuous-batching-lite scheduler.

Counterpart of ``repro.serve.decode``.  The scheduler keeps a fixed slot
pool; finished requests free their slot and queued requests prefill into
it.  The JAX scheduler reads each slot's new token from the device on
its own (``int(nxt[slot, 0])``); this one reads the step's ``(slots, 1)``
tokens in one device→host transfer, which gives the same tokens.  On a
CUDA device it counts the times each decode step made the host wait for
the device (``step_syncs``), through CUDA's sync debug mode, so that a
hidden read in the step (an ``.item()``, an ``int()``, a boolean index)
shows as a count above one.  PyTorch calls that mode a prototype that
does not see every synchronizing operation, so the count is a floor.

Like the JAX scheduler, this one builds no cross caches (its caches come
from ``init_cache(slots, capacity)`` without ``cross_len``): an enc-dec
model (whisper) is served as a decoder that never sees an encoder.  The
conditioned path is the model's own: ``init_cache(cross_len=)``,
``build_cross_caches``, ``prefill``, ``decode_step``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings

import numpy as np
import torch

from ..models.model import LModel


def make_serve_fns(model: LModel):
    """``(prefill_step, serve_step)``; decoding is greedy (the JAX
    package's ``temperature`` only scales the logits under the argmax)."""
    cfg = model.cfg

    def prefill_step(tokens, cache):
        return model.prefill(tokens, cache,
                             chunk=min(cfg.prefill_chunk, tokens.shape[1]))

    def serve_step(tokens_t, cache):
        """One decode step for the whole batch of slots (greedy)."""
        logits, cache = model.decode_step(tokens_t, cache)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt[:, None], logits, cache

    return prefill_step, serve_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)


# Cache leaves under 'blocks' are group-stacked: (n_groups, B, ...) — the
# batch axis is 1 there and 0 everywhere else ('rem', 'length').  The
# mixers' states are (conv_state, h) tuples.
def _walk(cache, fn, other=None, under_blocks=False):
    if isinstance(cache, tuple):
        return tuple(_walk(v, fn, None if other is None else other[i],
                           under_blocks) for i, v in enumerate(cache))
    if not isinstance(cache, dict):
        return fn(cache, other, 1 if under_blocks else 0)
    return {k: _walk(v, fn, None if other is None else other[k],
                     under_blocks or k == "blocks")
            for k, v in cache.items()}


def slot_view(cache, slot: int):
    """A batch-1 view of one slot of the batched cache."""
    return _walk(cache, lambda c, _, ax: c.narrow(ax, slot, 1))


def slot_write(cache, one, slot: int):
    """Write a batch-1 cache into the batched cache at ``slot``, in
    place; returns ``cache``."""
    _walk(cache, lambda full, single, ax: full.narrow(ax, slot, 1).copy_(
        single), one)
    return cache


_SYNC_WARNING = "called a synchronizing CUDA operation"


@contextlib.contextmanager
def _counting_syncs(device: torch.device, counts: list):
    """Appends to ``counts`` the number of host syncs (each device→host
    read is one) that the block made on ``device``, as CUDA's sync debug
    mode reports them; other warnings pass through.  The CPU has no
    device to wait for, and nothing is appended."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    syncs = [w for w in caught if _SYNC_WARNING in str(w.message)]
    counts.append(len(syncs))
    for w in caught:
        if w not in syncs:
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)


class BatchScheduler:
    """Continuous-batching-lite over a fixed slot pool (host-side control).

    Besides the JAX scheduler's state it keeps what a run measures: the
    host wall of each admission's prefill (``prefill_walls_s``, ending
    with the read of its first token) and of each decode step
    (``step_walls_s``, ending with the step's one read), and on CUDA the
    host syncs that each decode step made (``step_syncs``, measured: one
    is the token read)."""

    def __init__(self, model: LModel, *, slots: int, capacity: int):
        self.model = model
        self.slots = slots
        self.capacity = capacity
        self.prefill_step, self.serve_step = make_serve_fns(model)
        self.cache = model.init_cache(slots, capacity)
        self.active: dict[int, Request | None] = {i: None for i in range(slots)}
        self.last = torch.zeros((slots, 1), dtype=torch.int32,
                                device=model.device)
        self.queue: list[Request] = []
        self.done: list[Request] = []
        self.prefill_walls_s: list[float] = []
        self.step_walls_s: list[float] = []
        self.step_syncs: list[int] = []
        self.decode_steps = 0

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for slot, occupant in self.active.items():
            if occupant is None and self.queue:
                req = self.queue.pop(0)
                # per-slot prefill into a fresh batch-1 cache, then write the
                # slot back, KV rings and SSM states alike (path-aware:
                # 'blocks' leaves batch on axis 1, 'rem' leaves on axis 0)
                t0 = time.perf_counter()
                toks = torch.as_tensor(np.asarray(req.prompt),
                                       dtype=torch.int32,
                                       device=self.model.device)[None]
                slot_cache = self.model.init_cache(1, self.capacity)
                logits, slot_cache = self.prefill_step(toks, slot_cache)
                self.cache = slot_write(self.cache, slot_cache, slot)
                nxt = int(torch.argmax(logits, -1)[0])
                self.prefill_walls_s.append(time.perf_counter() - t0)
                req.out.append(nxt)
                self.last[slot, 0] = nxt
                self.active[slot] = req

    def step(self):
        """One global decode step; admits/evicts around it."""
        self._admit()
        if all(v is None for v in self.active.values()):
            return False
        t0 = time.perf_counter()
        with _counting_syncs(self.model.device, self.step_syncs):
            nxt, _, self.cache = self.serve_step(self.last, self.cache)
            self.last = nxt
            tokens = nxt[:, 0].tolist()      # the step's one device read
        self.step_walls_s.append(time.perf_counter() - t0)
        self.decode_steps += 1
        for slot, req in list(self.active.items()):
            if req is None:
                continue
            req.out.append(tokens[slot])
            if len(req.out) >= req.max_new:
                self.done.append(req)
                self.active[slot] = None
        return True

    def run(self):
        while self.step() or self.queue:
            pass
        return self.done
