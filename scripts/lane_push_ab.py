#!/usr/bin/env python3
"""The lane push (``push_ell.push_ell_lanes_reduce``, 3L and 3L-got) of two
or more trees of the port, in turns on one card.

    git archive <parent> src/repro_torch | tar -x -C build/parent
    python3 scripts/lane_push_ab.py --parent build/parent/src \
        [--extra label=path/to/src ...]

Times the lane push at every shape ``chip_smoke.py`` times it: bfs's
plus_one/min over the scale-22 R-MAT graph's forward ELL at k = 1, 8 and
32 lanes (``chip_smoke.SERVE_LANES``) on root 0's BFS frontiers (lane i
at level i mod 6) and on a random 1% frontier a lane, as the ``[serve]
lane push`` lines do; and with ``got`` on the streamed push partition
``chip_smoke.py``'s ``[stream] lane push with got`` line takes (of
``STREAM_PARTITIONS`` partitions, the one holding most of BFS level
``GOT_LEVEL``'s out-edges), there with the running table refilled and
``got`` cleared before each call, as a superstep finds them, and also
with ``got`` null.  The inputs are made once, here, from seed 0, and
saved under ``build/lane_push_ab/``; each tree builds only its
``push_ell.cu``, into its own ``build/``.  The trees run in turns as
``scripts/_ab.py`` sets out, and each prints one JSON line: for each
shape, CUDA-event ms of one call (the table's fill, the pre-pass and the
kernel), the profiler's device ms of the lane kernel and of the
pre-pass, and a hash of the output; the trees' hashes must agree.  The
card's name and power limit come first, then each tree's compiler report
of the lane kernel (registers, spills), then the streamed partition's
rows, live rows, messages, destinations and the largest in-message count
of a destination.  Needs a CUDA card; compare trees only within one
run.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

import _ab

ROOT = _ab.ROOT
sys.path.append(ROOT)
from chip_smoke import (INT_MAX, SCALE, SERVE_LANES,  # noqa: E402
                        STREAM_PARTITIONS, _device_ms, _time_ms, numpy_bfs)

WORK = os.path.join(ROOT, "build", "lane_push_ab")
OUT = os.path.join(ROOT, "chiprun_out", "lane_push_ab.json")
GOT_LEVEL = 1      # auto's heaviest push superstep at scale 22 (PERF.md)
RANDOM_LIVE = 0.01
INT32_MAX = 2**31 - 1


def make_inputs() -> dict:
    """The scale-22 graph's forward ELL, BFS levels and the streamed
    partition, on the CPU, saved for the timing processes."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import graph as G
    from repro_torch.core import preprocess
    from repro_torch.kernels.ref import PAD
    V, E = 1 << SCALE, 16 << SCALE
    src, dst = G.rmat_edges(V, E, seed=0)
    g = G.from_edge_list(src, dst, num_vertices=V)
    del src, dst
    offsets = g.edge_offsets.numpy().astype(np.int64)
    oracle = numpy_bfs(offsets, g.edges_dst.numpy(), 0, V)
    fe = preprocess.layouts_for(g).forward_ell(8)
    deg = g.out_degrees.numpy().astype(np.int64)
    cuts = G.edge_interval_cuts(deg, STREAM_PARTITIONS)
    store = preprocess.PartitionStore(g, cuts, width=8)
    front = oracle == GOT_LEVEL
    part = np.searchsorted(store.cuts[1:], np.flatnonzero(front),
                           side="right")
    p = int(np.argmax(np.bincount(part, weights=deg[front],
                                  minlength=store.partitions)))
    rows = int(store.rows_per_partition["push"][p])
    e = store.push_arrays(p)
    key, slot, wgt = (e[n][:rows].clone() for n in ("key", "slot", "wgt"))
    live = torch.as_tensor(front)[key.long()]
    dests = slot[live]
    dests = dests[dests != PAD].long()
    counts = torch.bincount(dests, minlength=V)
    inputs = {
        "row_src": fe.row_src, "dst": fe.dst, "wgt": fe.weights,
        "num_rows": int(fe.num_rows),
        "degrees": g.out_degrees.to(torch.int32),
        "levels": torch.as_tensor(np.minimum(oracle, INT_MAX)
                                  .astype(np.int32)),
        "part": {"key": key, "slot": slot, "wgt": wgt, "rows": rows,
                 "partition": p, "live_rows": int(live.sum()),
                 "messages": int(dests.numel()),
                 "destinations": int((counts > 0).sum()),
                 "max_in": int(counts.max())}}
    os.makedirs(WORK, exist_ok=True)
    torch.save(inputs, os.path.join(WORK, "inputs.pt"))
    return inputs


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_tree(label: str) -> dict:
    """The timings of the ``repro_torch`` on ``sys.path``."""
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("lane_push_ab: no CUDA card")
    _build.SOURCES = ("push_ell",)          # only the kernel timed here
    from repro_torch.kernels import push_ell as pe
    inp = torch.load(os.path.join(WORK, "inputs.pt"))
    dev = torch.device("cuda", 0)
    row_src, dst, wgt = (inp[n].to(dev) for n in ("row_src", "dst", "wgt"))
    deg = inp["degrees"].to(dev)
    levels = inp["levels"].to(dev)
    V = levels.numel()
    R = inp["num_rows"]
    kw = dict(gather="plus_one", reduce="min", identity=INT32_MAX)
    kernel = "push_ell_lanes"
    out = {"tree": label}
    nlev = int(levels[levels < INT_MAX].max()) + 1
    for k in SERVE_LANES:
        values = levels.expand(k, V).contiguous()
        lanes = list(range(k))
        for name in ("bfs", "random"):
            if name == "bfs":
                active = torch.stack([levels == (i % nlev)
                                      for i in range(k)])
            else:
                gen = torch.Generator().manual_seed(1000 + k)
                active = (torch.rand((k, V), generator=gen)
                          < RANDOM_LIVE).to(dev)

            def call(values=values, active=active, lanes=lanes):
                return pe.push_ell_lanes_reduce(
                    row_src, dst, wgt, values, deg, active, lanes,
                    num_rows=R, **kw)

            res = call()
            out[f"k{k}_{name}"] = {
                "ms": _time_ms(torch, call, reps=20, batch=5),
                "device_ms": _device_ms(torch, call, kernel),
                "pack_device_ms": _device_ms(torch, call, "lanes_pack"),
                "hash": _digest(res)}
            del res, active
        del values
    # the streamed partition with got, at GOT_LEVEL
    part = inp["part"]
    key, slot, pw = (part[n].to(dev) for n in ("key", "slot", "wgt"))
    vals = torch.where(levels <= GOT_LEVEL, levels, INT_MAX)[None] \
        .contiguous()
    act = (levels == GOT_LEVEL)[None].contiguous()
    prep = pe.push_lanes_prepare(act, [0])
    table = torch.full((1, V), INT32_MAX, dtype=torch.int32, device=dev)
    got = torch.zeros((1, V), dtype=torch.bool, device=dev)
    args = (key, slot, pw, vals, deg, act, [0])
    pkw = dict(kw, num_rows=part["rows"], table=table, prepared=prep)
    for name, g in (("got", got), ("no_got", None)):
        def call(g=g):
            table.fill_(INT32_MAX)
            if g is not None:
                g.zero_()
            return pe.push_ell_lanes_reduce(*args, got=g, **pkw)

        call()
        out[f"stream_{name}"] = {
            "ms": _time_ms(torch, call, reps=20, batch=5),
            "device_ms": _device_ms(torch, call, kernel),
            "hash": _digest(table, got) if g is not None
            else _digest(table)}
    return out


def build_tree(label: str) -> dict:
    """Build the tree's push_ell.cu alone; from the compiler's report, the
    lane kernels' most registers and any that spill."""
    from repro_torch.kernels import _build
    _build.SOURCES = ("push_ell",)
    rep = _build.build(ptxas_verbose=True)
    fn, regs, spills, n = None, 0, set(), 0
    for ln in rep["ptxas"].get("push_ell", "").splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln
            n += "push_ell_lanes" in fn
        elif fn is not None and "push_ell_lanes" in fn:
            if "Used" in ln and "registers" in ln:
                regs = max(regs, int(ln.split("Used")[1].split()[0]))
            if "spill" in ln and not ln.strip().startswith("0 bytes stack") \
                    and (" 0 bytes spill stores" not in ln
                         or " 0 bytes spill loads" not in ln):
                spills.add(fn)
    return {"tree": label, "seconds": rep["seconds"], "lane_kernels": n,
            "max_registers": regs, "spilling": sorted(spills)}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--parent", help="the parent tree's src directory")
    p.add_argument("--extra", action="append", default=[],
                   help="label=path/to/src of another tree")
    p.add_argument("--time", help=argparse.SUPPRESS)    # one child run
    p.add_argument("--build", help=argparse.SUPPRESS)   # one child build
    args = p.parse_args(argv)
    if args.time:
        print(json.dumps(time_tree(args.time)), flush=True)
        return
    if args.build:
        print(json.dumps(build_tree(args.build)), flush=True)
        return
    if not args.parent:
        p.error("--parent is required")
    smi = _ab.card()
    tree_of = _ab.trees(args.parent, args.extra)
    builds = {label: _ab.spawn(__file__, tree, "--build", label)
              for label, tree in tree_of.items()}
    t0 = time.perf_counter()
    inputs = make_inputs()
    shapes = {"inputs_s": time.perf_counter() - t0,
              "got_partition": {k: v for k, v in inputs["part"].items()
                                if not hasattr(v, "shape")}}
    del inputs
    report = {"smi": smi, "shapes": shapes,
              "builds": [_ab.last_line(proc, f"build of {label}")
                         for label, proc in builds.items()]}
    print(json.dumps(shapes), flush=True)
    report["runs"] = _ab.run_in_turns(__file__, tree_of)
    differ = _ab.differing(report["runs"])
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(report, f, indent=1)
    if differ:
        raise SystemExit(f"the trees' outputs differ at {differ}")
    print(json.dumps({"outputs_equal": sorted(
        k for k, v in report["runs"][0].items() if isinstance(v, dict))}),
        flush=True)


if __name__ == "__main__":
    main()
