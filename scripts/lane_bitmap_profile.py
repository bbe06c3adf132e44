#!/usr/bin/env python3
"""Where the bitmap plane's batched superstep spends its device time.

    python3 scripts/lane_bitmap_profile.py

Builds the scale-22 R-MAT graph of ``chip_smoke.py``'s main phase (edge
factor 16, seed 0), translates bfs on the bitmap plane under
``direction='pull'`` and, at k = 8 and 32 lanes on random narrow
frontiers (1,000 vertices a lane, numpy seed 7, as the ``[serve_bitmap]
route A/B`` lines take them), checks one batched superstep
(``lane_step``: the touched pass, the flags, 2L, the apply) against the
k single-lane supersteps (values, frontiers and counters), then profiles
5 steady batched supersteps with ``torch.profiler`` and prints the
device ms a superstep, the kernels and the ATen ops by device time.
Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 5


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import dsl
    from repro_torch.core import graph as G
    from repro_torch.core.scheduler import DirectionPolicy, ScheduleConfig
    from repro_torch.core.translator import translate
    from repro_torch.kernels import _build
    _build.SOURCES = ("edge_block", "push_ell")     # the kernels it runs
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    V, E = 1 << 22, 16 << 22
    src, dst = G.rmat_edges(V, E, seed=0)
    g = G.from_edge_list(src, dst, num_vertices=V)
    prog = translate(dsl.bfs_program(), g, ScheduleConfig(
        pull_sweep="bitmap", direction=DirectionPolicy(mode="pull")),
        device="cuda")
    out_deg = g.out_degrees.to(device="cuda", dtype=torch.int32)
    rng = np.random.default_rng(7)
    for k in (8, 32):
        active = torch.zeros((k, V), dtype=torch.bool)
        for i in range(k):
            active[i, torch.as_tensor(rng.choice(V, 1000,
                                                 replace=False))] = True
        values = torch.where(active, 0, 2**30).to(torch.int32).cuda()
        active = active.cuda()
        m_f = torch.where(active, out_deg, 0).sum(
            1, dtype=torch.int64).tolist()
        args = (values, active, list(range(k)), [True] * k, [], m_f)
        new, nxt, cnt = prog._lane_step(*args)
        for i in range(k):
            n, x, c = prog._pull_step(values[i], active[i], m_f[i])
            if not (torch.equal(n, new[i]) and torch.equal(x, nxt[i])
                    and [int(t) for t in c] == [int(t) for t in cnt[i]]):
                raise AssertionError(f"k={k}: lane {i} != its single-lane "
                                     "superstep")
        for _ in range(3):
            prog._lane_step(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(STEPS):
                prog._lane_step(*args)
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = sorted((e for e in events
                          if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.self_device_time_total,
                         reverse=True)
        ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                      and e.self_device_time_total > 0),
                     key=lambda e: e.self_device_time_total, reverse=True)
        total = sum(e.self_device_time_total for e in kernels)
        print(f"k={k} narrow frontiers: the batched superstep = {k} "
              f"single-lane supersteps; device {total / STEPS / 1e3:.4f} "
              f"ms a superstep", flush=True)
        for e in kernels[:12]:
            print(f"  kernel {e.self_device_time_total / STEPS / 1e3:8.4f} "
                  f"ms x{e.count / STEPS:.0f}  {e.key[:100]}")
        for e in ops[:10]:
            print(f"  op {e.self_device_time_total / STEPS / 1e3:8.4f} ms "
                  f"x{e.count / STEPS:.0f}  {e.key}")


if __name__ == "__main__":
    main()
