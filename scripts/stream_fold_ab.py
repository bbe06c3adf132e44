#!/usr/bin/env python3
"""The streamed engine's pull partials (1L-acc, its pre-pass, 1+4) of two
or more trees of the port, in turns on one card.

    git archive <parent> src/repro_torch | tar -x -C build/parent
    python3 scripts/stream_fold_ab.py --parent build/parent/src \
        [--extra label=path/to/src ...]

Times, at the shapes ``chip_smoke.py``'s ``[stream]`` lines take them:

* ``fold_k1`` / ``fold_k8``: ``edge_block_fold_lanes(accumulate=True)``
  (bfs's plus_one/min) on the largest pull partition of the scale-22
  R-MAT graph in ``STREAM_PARTITIONS`` partitions, at the widest BFS
  level's frontier, 1 and 8 lanes (every lane at that level), the running
  table refilled before each call as the superstep's first partition
  finds it;
* ``prepare_k1`` / ``prepare_k8``: its pre-pass (``lanes_prepare``);
* ``add_route``: the streamed float add on the largest pull partition of
  the scale-20 pagerank (seed 1, every vertex live), as the tree's
  streamed engine runs it: the fused ``edge_block_add_fold_lanes`` where
  the tree has it, else kernel 1 on prepared tables, kernel 4 and the
  add; ``add_parent`` that older route in every tree.

Each shape gives CUDA-event ms of one call (with the wrappers' host time),
the profiler's device ms of its kernels and a hash of its output; the
trees' hashes must agree, and ``add_route`` must equal ``add_parent``.
The inputs are made once, here, from seed 0 (bfs) and seed 1 (pagerank),
and saved under ``build/stream_fold_ab/``; each tree builds only the
sources it needs, into its own ``build/``.  The trees run in turns as
``scripts/_ab.py`` sets out.  The card's name and power limit come first,
then each tree's compiler report of the fold kernels (registers, spills)
and the partitions' rows, owners and frontier.  Needs a CUDA card;
compare trees only within one run.
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
from chip_smoke import (INT_MAX, OTHERS_SCALE, SCALE,  # noqa: E402
                        STREAM_PARTITIONS, _device_ms, _time_ms, numpy_bfs)

WORK = os.path.join(ROOT, "build", "stream_fold_ab")
OUT = os.path.join(ROOT, "chiprun_out", "stream_fold_ab.json")
LANES = (1, 8)
INT32_MAX = 2**31 - 1
# the kernels of the float add's routes, by the names the profiler gives
# them (kernel 1, kernel 4, the add; the fused fold)
ADD_KERNELS = ("edge_block", "segment_", "CUDAFunctor_add", "stream_fold")


def _largest_pull(g, torch):
    """The largest pull partition of ``g`` in ``STREAM_PARTITIONS``: its
    (key, slot, wgt) real rows and partition index."""
    from repro_torch.core import graph as G
    from repro_torch.core import preprocess
    deg = g.out_degrees.numpy().astype(np.int64)
    cuts = G.edge_interval_cuts(deg, STREAM_PARTITIONS)
    store = preprocess.PartitionStore(g, cuts, width=8)
    p = int(np.argmax(store.rows_per_partition["pull"]))
    rows = int(store.rows_per_partition["pull"][p])
    e = store.pull_arrays(p)
    return {n: e[n][:rows].clone() for n in ("key", "slot", "wgt")}, p, \
        store.cuts


def make_inputs() -> dict:
    """The scale-22 bfs partition and levels, the scale-20 pagerank
    partition, on the CPU, saved for the timing processes."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import graph as G
    V, E = 1 << SCALE, 16 << SCALE
    src, dst = G.rmat_edges(V, E, seed=0)
    g = G.from_edge_list(src, dst, num_vertices=V)
    del src, dst
    oracle = numpy_bfs(g.edge_offsets.numpy().astype(np.int64),
                       g.edges_dst.numpy(), 0, V)
    wide = int(np.argmax(np.bincount(oracle[oracle < INT_MAX])))
    part, p, cuts = _largest_pull(g, torch)
    key = part["key"]
    inputs = {"levels": torch.as_tensor(np.minimum(oracle, INT_MAX)
                                        .astype(np.int32)),
              "degrees": g.out_degrees.to(torch.int32), "wide": wide,
              "bfs": part,
              "bfs_shape": {"partition": p, "rows": int(key.numel()),
                            "interval": int(cuts[p + 1] - cuts[p]),
                            "owners": int(torch.unique(key[key < V])
                                          .numel()),
                            "level": wide,
                            "frontier": int((oracle == wide).sum())}}
    del g
    V2 = 1 << OTHERS_SCALE
    src, dst = G.rmat_edges(V2, 16 * V2, seed=1)
    g2 = G.from_edge_list(src, dst, num_vertices=V2)
    del src, dst
    part2, p2, _ = _largest_pull(g2, torch)
    key2 = part2["key"]
    inputs.update({
        "pr": part2, "pr_degrees": g2.out_degrees.to(torch.int32),
        "pr_shape": {"partition": p2, "rows": int(key2.numel()),
                     "owners": int(torch.unique(key2[key2 < V2]).numel())}})
    os.makedirs(WORK, exist_ok=True)
    torch.save(inputs, os.path.join(WORK, "inputs.pt"))
    return inputs


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _kernel_ms(torch, fn, names):
    """The profiler's device ms of ``fn`` summed over the kernels named
    (those the tree launches), or None where it kept none."""
    ms = [_device_ms(torch, fn, n) for n in names]
    kept = [m for m in ms if m is not None]
    return sum(kept) if kept else None


def _sources():
    """The tree's kernel sources this script needs (an older tree has no
    stream_fold.cu)."""
    from repro_torch.kernels import _build
    return tuple(s for s in ("edge_block", "segment_sum", "stream_fold")
                 if (_build.CSRC / f"{s}.cu").exists())


def time_tree(label: str) -> dict:
    """The timings of the ``repro_torch`` on ``sys.path``."""
    import types
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("stream_fold_ab: no CUDA card")
    _build.SOURCES = _sources()
    from repro_torch.kernels import edge_block as eb
    from chip_smoke import _add_fold_parent
    inp = torch.load(os.path.join(WORK, "inputs.pt"))
    dev = torch.device("cuda", 0)
    out = {"tree": label}
    # 1L-acc and its pre-pass
    levels = inp["levels"].to(dev)
    deg = inp["degrees"].to(dev)
    V = levels.numel()
    wide = inp["wide"]
    b = {n: t.to(dev) for n, t in inp["bfs"].items()}
    view = types.SimpleNamespace(flat_dst=b["slot"], flat_wgt=b["wgt"],
                                 owner8=b["key"])
    for k in LANES:
        vals = torch.where(levels <= wide, levels, INT_MAX) \
            .expand(k, V).contiguous()
        act = (levels == wide).expand(k, V).contiguous()
        lanes = list(range(k))
        prep = eb.lanes_prepare(vals, deg, act, lanes, gather="plus_one")
        red = torch.empty((k, V), dtype=torch.int32, device=dev)

        def fold(vals=vals, act=act, lanes=lanes, prep=prep, red=red):
            red.fill_(INT32_MAX)
            return eb.edge_block_fold_lanes(
                view, vals, deg, act, lanes, gather="plus_one",
                reduce="min", need_got=False, red=red, accumulate=True,
                prepared=prep)

        def prepare(vals=vals, act=act, lanes=lanes):
            return eb.lanes_prepare(vals, deg, act, lanes, gather="plus_one")

        fold()
        out[f"fold_k{k}"] = {
            "ms": _time_ms(torch, fold, reps=20, batch=5),
            "device_ms": _device_ms(torch, fold, "edge_block_fold"),
            "hash": _digest(red)}
        res = prepare()
        out[f"prepare_k{k}"] = {
            "ms": _time_ms(torch, prepare, reps=20, batch=5),
            "device_ms": _kernel_ms(torch, prepare, ("lanes_pack",)),
            "hash": _digest(*(t for c in res.chunks for t in c[4:]
                              if t is not None))}
        del vals, act, red, prep, res
    # the streamed float add (1+4, or its fused kernel)
    deg2 = inp["pr_degrees"].to(dev)
    V2 = deg2.numel()
    q = {n: t.to(dev) for n, t in inp["pr"].items()}
    pview = types.SimpleNamespace(flat_dst=q["slot"], flat_wgt=q["wgt"],
                                  owner8=q["key"])
    vals2 = torch.ones((1, V2), device=dev)
    act2 = torch.ones((1, V2), dtype=torch.bool, device=dev)
    kw = dict(gather="div_deg", mask_inactive=False)
    prep1 = eb.edge_block_prepare(vals2[0], deg2, act2[0], **kw)
    red2 = torch.zeros((1, V2), device=dev)

    def parent():
        red2.zero_()
        return _add_fold_parent(torch, pview, vals2, deg2, act2, [0],
                                red=red2, got=None, prepared=prep1, **kw)

    shapes = {"add_parent": parent}
    if hasattr(eb, "edge_block_add_fold_lanes"):
        prep = eb.lanes_prepare(vals2, deg2, act2, [0], **kw)

        def fused():
            red2.zero_()
            return eb.edge_block_add_fold_lanes(
                pview, vals2, deg2, act2, [0], red=red2, prepared=prep, **kw)

        shapes["add_route"] = fused
    else:
        shapes["add_route"] = parent
    for name, fn in shapes.items():
        fn()
        out[name] = {"ms": _time_ms(torch, fn, reps=20, batch=5),
                     "device_ms": _kernel_ms(torch, fn, ADD_KERNELS),
                     "hash": _digest(red2)}
    if out["add_route"]["hash"] != out["add_parent"]["hash"]:
        raise SystemExit(f"{label}: the float-add route differs from the "
                         "route it replaced")
    return out


def build_tree(label: str) -> dict:
    """Build the tree's sources; from the compiler's report, each timed
    kernel's most registers and any instantiation that spills."""
    from repro_torch.kernels import _build
    _build.SOURCES = _sources()
    rep = _build.build(ptxas_verbose=True)
    names = ("edge_block_fold", "lanes_pack", "stream_fold")
    fn, regs, spills = None, {}, set()
    for text in rep["ptxas"].values():
        for ln in text.splitlines():
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1] if "'" in ln else ln
                kind = next((s for s in names if s in fn), None)
            elif fn is not None and kind is not None:
                if "Used" in ln and "registers" in ln:
                    regs[kind] = max(regs.get(kind, 0),
                                     int(ln.split("Used")[1].split()[0]))
                if "spill" in ln and (" 0 bytes spill stores" not in ln
                                      or " 0 bytes spill loads" not in ln):
                    spills.add(fn)
    return {"tree": label, "seconds": rep["seconds"],
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
              "bfs": inputs["bfs_shape"], "pagerank": inputs["pr_shape"]}
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
