"""Serving driver: continuous-batching decode over a slot pool.

Counterpart of ``repro.launch.serve``, on the GPU unless told otherwise:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        --smoke --device cpu

The flags are the JAX driver's plus ``--device`` (default: the CUDA
device, raising without one), ``--dtype`` (the parameters' dtype; default
each spec's own, bf16 weights and float32 norms) and the prompt length
range (default 2–7 tokens, the JAX driver's); the cache is bf16, as
there.  Learned positions (whisper) get ``--capacity`` rows, as there;
whisper is served as the JAX scheduler serves it, with no cross caches
(``serve.decode``).
Weights are drawn from a ``torch.Generator`` seeded with ``--seed``,
prompts from numpy's generator with the same seed.  ``main`` returns the
scheduler; its ``done`` list is what the JAX ``main`` returns.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from ..configs.registry import get_config, smoke_config
from ..core.comm import resolve_device
from ..models.model import LModel
from ..serve.decode import BatchScheduler, Request

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None) -> BatchScheduler:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-8b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--capacity", type=int, default=64)
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--max-new", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None)
    p.add_argument("--dtype", choices=sorted(_DTYPES), default=None)
    p.add_argument("--min-prompt", type=int, default=2)
    p.add_argument("--max-prompt", type=int, default=7,
                   help="longest prompt, in tokens (inclusive)")
    args = p.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    model = LModel(cfg, max_seq=args.capacity
                   if cfg.pos_emb == "learned" else 0, device=device,
                   generator=torch.Generator(device=device).manual_seed(
                       args.seed),
                   dtype=_DTYPES[args.dtype] if args.dtype else None)
    sched = BatchScheduler(model, slots=args.slots, capacity=args.capacity)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"built {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}) "
          f"on {device} in {time.perf_counter() - t0:.2f}s")
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    for rid in range(args.requests):
        plen = int(rng.integers(args.min_prompt, args.max_prompt + 1))
        prompt = rng.integers(0, cfg.vocab_size, plen)
        sched.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))
    done = sched.run()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s)")
    steps = sched.step_walls_s
    if steps:
        syncs = (f"host syncs a step {min(sched.step_syncs)}–"
                 f"{max(sched.step_syncs)}" if sched.step_syncs
                 else "host syncs not counted on the CPU")
        print(f"prefill {statistics.mean(sched.prefill_walls_s):.4f}s per "
              f"request; decode {sched.decode_steps} steps, median "
              f"{1e3 * statistics.median(steps):.3f} ms, {syncs}")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] → {r.out}")
    return sched


if __name__ == "__main__":
    main()
