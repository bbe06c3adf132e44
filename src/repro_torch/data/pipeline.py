"""Deterministic, resumable, sharded synthetic token pipeline.

Counterpart of ``repro.data.pipeline``.  Batch contents are a pure
function of ``(seed, step, process_index)`` (numpy's generator on that
``SeedSequence``, the JAX package's arrays exactly), so a restart needs no
replay log: the restored ``step`` is the only pipeline state.  A
background thread makes the next batches and copies them to the device
from pinned host memory on a side CUDA stream, behind the step's compute.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeConfig


def synth_batch(cfg: ArchConfig, shape: ShapeConfig, step: int, *,
                seed: int = 0, process_index: int = 0,
                process_count: int = 1) -> dict:
    """Per-host shard of the global batch for ``step`` (numpy, host-side)."""
    b_local = shape.global_batch // process_count
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, process_index]))
    tokens = rng.integers(0, cfg.vocab_size,
                          (b_local, shape.seq_len), dtype=np.int32)
    # next-token LM objective: labels = shifted tokens
    labels = np.concatenate(
        [tokens[:, 1:], tokens[:, :1]], axis=1).astype(np.int32)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.enc_dec:
        batch["enc_inputs"] = rng.normal(
            0, 1, (b_local, shape.seq_len, cfg.d_model)).astype(np.float32)
    return batch


def device_put(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``: on CUDA through pinned host
    memory on the current stream (the caller's side stream), recorded on
    the device's default stream, where the step consumes it."""
    device = torch.device(device)
    if device.type != "cuda":
        return {k: torch.as_tensor(v, device=device)
                for k, v in batch.items()}
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
        out[k] = t.to(device, non_blocking=True)
        out[k].record_stream(torch.cuda.default_stream(device))
    return out


class Prefetcher:
    """Double-buffered host→device prefetch (overlap with compute): a
    thread makes batch ``step``, ``step + 1``, ... with ``make_batch`` and
    puts each on ``device`` (``device_put``; on CUDA on a side stream,
    synchronized before the batch is handed over), or through ``put_fn``
    when given."""

    def __init__(self, make_batch, start_step: int, *, depth: int = 2,
                 device=None, put_fn=None):
        self._make = make_batch
        if put_fn is None:
            device = torch.device(device or "cpu")
            put_fn = lambda b: device_put(b, device)   # noqa: E731
        self._put = put_fn
        self._stream = (torch.cuda.Stream(device) if device is not None
                        and torch.device(device).type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            if self._stream is None:
                batch = self._put(self._make(step))
            else:
                with torch.cuda.stream(self._stream):
                    batch = self._put(self._make(step))
                self._stream.synchronize()
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.05)
                    break
                except queue.Full:
                    pass
            step += 1

    def __iter__(self) -> Iterator[tuple[int, Any]]:
        while True:
            yield self._q.get()

    def close(self):
        """Stop the thread and drop the batches it made."""
        self._stop.set()
        self._thread.join()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
