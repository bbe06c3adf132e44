#!/usr/bin/env python3
"""The served LM decode step of two or more trees of the port, in turns on
one card.

    git archive <parent> src/repro_torch | tar -x -C build/parent
    python3 scripts/lm_step_ab.py --parent build/parent/src \
        [--extra label=path/to/src ...]

Serves qwen3-8b (8 slots of 4,096, as ``chip_smoke.LM_SERVE``) and
falcon-mamba-7b (4 slots of 2,048, as ``chip_smoke.LM_FAMILY_SERVE``) at
full width through ``launch.serve.main`` with random bf16 weights, and
reads the scheduler's decode-step walls (each ends with the step's one
host read, so a host-bound step's wall is its host time).  The trees run
in turns as ``scripts/_ab.py`` sets out (each builds its kernels once,
into its own ``build/``), and each prints one JSON line: for each model
the median, min and max ms of its decode steps and their count.  The card's name and power limit
come first.  Needs a CUDA card; compare trees only within one run.
"""
from __future__ import annotations

import argparse
import json

import _ab

# model: launch.serve flags (prompts shorter and fewer requests than
# chip_smoke.py's, one wave of slots: the decode step is what is timed)
RUNS = {"qwen3-8b": dict(arch="qwen3-8b", slots=8, capacity=4096,
                         requests=8, min_prompt=256, max_prompt=512,
                         max_new=48, seed=0, device="cuda"),
        "falcon-mamba-7b": dict(arch="falcon-mamba-7b", slots=4,
                                capacity=2048, requests=4, min_prompt=256,
                                max_prompt=512, max_new=48, seed=0,
                                device="cuda")}


def time_tree(label: str) -> dict:
    """The decode steps of the ``repro_torch`` on ``sys.path``."""
    import gc

    import numpy as np
    import torch
    from repro_torch.launch import serve
    if not torch.cuda.is_available():
        raise SystemExit("lm_step_ab: no CUDA card")
    out = {"tree": label}
    for name, conf in RUNS.items():
        argv = [a for k, v in conf.items()
                for a in (f"--{k.replace('_', '-')}", str(v))]
        sched = serve.main(argv)
        torch.cuda.synchronize()
        ms = [1e3 * w for w in sched.step_walls_s]
        out[name] = {"median_ms": float(np.median(ms)), "min_ms": min(ms),
                     "max_ms": max(ms), "steps": len(ms)}
        del sched
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--parent", help="the parent tree's src directory")
    p.add_argument("--extra", action="append", default=[],
                   help="label=src of another tree, run between the two")
    p.add_argument("--time", help=argparse.SUPPRESS)   # one child run
    args = p.parse_args(argv)
    if args.time:
        print(json.dumps(time_tree(args.time)), flush=True)
        return
    if not args.parent:
        p.error("--parent is required")
    _ab.card()
    _ab.run_in_turns(__file__, _ab.trees(args.parent, args.extra))


if __name__ == "__main__":
    main()
