#!/usr/bin/env python3
"""Kernel 5 (``decode_gqa``) of two trees of the port, in turns on one card.

    git archive <parent> src/repro_torch | tar -x -C build/parent
    python3 scripts/decode_gqa_ab.py --parent build/parent/src

Times kernel 5 at every shape ``chip_smoke.py`` times it, in bf16:
qwen3-8b's served decode step (B 8, S 4096, K 8, G 4, h 128), one long
row (``chip_smoke.LONG_SHAPE``) and grok-1-314b's step
(``chip_smoke.GROK_SHAPE``).  The trees run in turns as
``scripts/_ab.py`` sets out (each builds its kernels once, into its own
``build/``), and each run prints one JSON line: for each shape,
CUDA-event ms of one call in batches of 20 and the profiler's device
ms.  The calls pass only the arguments every
tree of kernel 5 takes (no ``softcap``: ``chip_smoke.py`` times the
capped kernel beside the uncapped one).  The card's name and power limit
come first.  Needs a CUDA card; compare two trees only within one run.
"""
from __future__ import annotations

import argparse
import json
import sys

import _ab

sys.path.append(_ab.ROOT)
from chip_smoke import (GROK_SHAPE, LONG_SHAPE, _device_ms,  # noqa: E402
                        _time_ms)

# name: (B, S, K, G, h)
SHAPES = {"qwen_served": (8, 4096, 8, 4, 128),
          "long_row": LONG_SHAPE,
          "grok": GROK_SHAPE}


def _inputs(torch, B, S, K, G, h, seed):
    """Random bf16 caches with rows of S/8 to S/2 valid slots."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lengths = torch.randint(S // 8, S // 2, (B,), generator=gen,
                            device="cuda")
    slots = torch.arange(S, device="cuda")
    q = torch.randn((B, K, G, h), generator=gen, device="cuda").bfloat16()
    kc, vc = (torch.randn((B, S, K, h), generator=gen,
                          device="cuda").bfloat16() for _ in range(2))
    pos = torch.where(slots[None] < lengths[:, None], slots[None],
                      -1).to(torch.int32).contiguous()
    return q, kc, vc, pos, lengths.to(torch.int32)


def time_tree(label: str) -> dict:
    """The timings of the ``repro_torch`` on ``sys.path``."""
    import torch
    from repro_torch.kernels import decode_gqa as dg
    if not torch.cuda.is_available():
        raise SystemExit("decode_gqa_ab: no CUDA card")
    out = {"tree": label}
    for seed, (name, shape) in enumerate(SHAPES.items()):
        args = _inputs(torch, *shape, seed=seed)
        fn = lambda: dg.decode_gqa(*args)  # noqa: E731
        out[name] = [_time_ms(torch, fn, reps=30, batch=20),
                     _device_ms(torch, fn, "decode_gqa", calls=50)]
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--parent", help="the parent tree's src directory")
    p.add_argument("--time", help=argparse.SUPPRESS)   # one child run
    args = p.parse_args(argv)
    if args.time:
        print(json.dumps(time_tree(args.time)), flush=True)
        return
    if not args.parent:
        p.error("--parent is required")
    _ab.card()
    _ab.run_in_turns(__file__, _ab.trees(args.parent))


if __name__ == "__main__":
    main()
