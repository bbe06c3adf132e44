#!/usr/bin/env python3
"""2L, the bitmap plane's lane sweep, of two or more trees of the port, in
turns on one card.

    git archive <parent> src/repro_torch | tar -x -C build/parent
    python3 scripts/lane_bitmap_ab.py --parent build/parent/src \
        [--extra label=path/to/src ...]

Times, at the shapes ``chip_smoke.py``'s ``[serve_bitmap]`` lines take
them (bfs's plus_one/min over the scale-22 R-MAT graph's flat pull view,
grid blocks of 128 sub-rows, ``direction='pull'``), at k = 1, 8 and 32
lanes on three frontier sets (``chip_smoke.BITMAP_LANE_SETS``): root 0's
BFS frontiers (lane i at level i mod the levels, with the BFS's state
then), 1,000 random vertices a lane (numpy seed 7) and a random 1% a lane:

* ``2l``: the fold on the lanes' flags as the tree's batched superstep
  builds them (the tree's ``lane_block_words`` where it has one, else
  ``pull_bitmap.grid_block_live``), with its fills and its own pre-pass:
  CUDA-event ms, and the profiler's device ms of the fold kernel, of its
  pre-pass and of the flags' construction;
* ``1l``: the fold without flags on the same states;
* ``step``: the tree's batched bitmap superstep (``lane_step``: the
  touched pass, the flags, 2L, the apply), and ``dense``: the dense
  plane's batched superstep (1L) on the same states;
* on the BFS sets (this tree only, where ``lane_block_words`` exists) the
  wide lanes' two routes: in the narrow lanes' launch with every bit set
  (``shared``), or a 1L launch of their own (``split``);
* ``prepare50``: the lane pre-pass on a 50% random frontier a lane (1L's
  shape in ``[serve]``): the tree's own, which writes every message
  (the parent's) or, under mask_inactive, the active vertices' only.

Each gives a hash of its output; the trees' hashes must agree.  The
graph, its BFS levels and its layouts are made once, here, and saved
under ``build/lane_bitmap_ab/``; each tree builds ``edge_block.cu`` and
``push_ell.cu`` into its own ``build/``.  The trees run in turns as
``scripts/_ab.py`` sets out.  The card's name and power limit come first,
then each tree's compiler report of the lane fold kernels and the flags
pass (registers, spill bytes an instantiation).  Needs a CUDA card;
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
from chip_smoke import (BITMAP_LANE_SETS, INT_MAX, SCALE,  # noqa: E402
                        SERVE_LANES, _device_ms, _time_ms, numpy_bfs)

WORK = os.path.join(ROOT, "build", "lane_bitmap_ab")
OUT = os.path.join(ROOT, "chiprun_out", "lane_bitmap_ab.json")
GRID_ROWS = 128
# the compiler-report names of the kernels whose registers and spills are
# kept
REPORTED = ("edge_block_skip_fold", "edge_block_fold", "lanes_pack",
            "words_kernel", "lanes_flags_pack")


def make_inputs() -> None:
    """The scale-22 graph and its BFS levels, saved for the timing
    processes."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import graph as G
    V, E = 1 << SCALE, 16 << SCALE
    src, dst = G.rmat_edges(V, E, seed=0)
    g = G.from_edge_list(src, dst, num_vertices=V)
    del src, dst
    oracle = numpy_bfs(g.edge_offsets.numpy().astype(np.int64),
                       g.edges_dst.numpy(), 0, V)
    os.makedirs(WORK, exist_ok=True)
    torch.save({"graph": g, "levels": torch.as_tensor(
        np.minimum(oracle, INT_MAX).astype(np.int32))},
        os.path.join(WORK, "inputs.pt"))


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _states(torch, levels, out_deg, V, k, label, rng):
    """The (k, V) values and frontiers of one set, on the card."""
    if label == "bfs":
        top = int(levels[levels < INT_MAX].max())
        lvls = [i % (top + 1) for i in range(k)]
        values = torch.stack([torch.where(levels <= lv, levels, INT_MAX)
                              for lv in lvls])
        active = torch.stack([levels == lv for lv in lvls])
    else:
        n = 1000 if label == "narrow" else V // 100
        active = torch.zeros((k, V), dtype=torch.bool)
        for i in range(k):
            active[i, torch.as_tensor(rng.choice(V, n, replace=False))] = 1
        values = torch.where(active, 0, INT_MAX).to(torch.int32)
    return values.to("cuda"), active.to("cuda")


def time_tree(label: str) -> dict:
    """The timings of the ``repro_torch`` on ``sys.path``."""
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("lane_bitmap_ab: no CUDA card")
    _build.SOURCES = ("edge_block", "push_ell")
    from repro_torch.core import dsl, preprocess
    from repro_torch.core.scheduler import DirectionPolicy, ScheduleConfig
    from repro_torch.core.translator import translate
    from repro_torch.kernels import edge_block as eb
    from repro_torch.kernels import pull_bitmap as pb
    from repro_torch.kernels import push_ell as pe
    inp = torch.load(os.path.join(WORK, "inputs.pt"), weights_only=False)
    g, levels = inp["graph"], inp["levels"]
    t0 = time.perf_counter()
    lay = preprocess.layouts_for(g)
    pplan = lay.on(lay.pull_plan(64), "cuda")
    fe = lay.on(lay.forward_ell(8), "cuda")
    pull = DirectionPolicy(mode="pull")
    bitmap = translate(dsl.bfs_program(), g, ScheduleConfig(
        pull_sweep="bitmap", direction=pull), device="cuda")
    dense = translate(dsl.bfs_program(), g, ScheduleConfig(
        pull_sweep="dense", direction=pull), device="cuda")
    caps = bitmap.report.pull_block_tiers
    out_deg = g.out_degrees.to(device="cuda", dtype=torch.int32)
    V = g.num_vertices
    levels = levels.to("cuda")
    words_route = hasattr(eb, "lane_block_words")
    skip_kernel = "edge_block_skip_fold" if words_route \
        else "edge_block_fold"
    kw = dict(gather="plus_one", reduce="min", mask_inactive=True)
    out = {"tree": label, "setup_s": time.perf_counter() - t0,
           "words_route": words_route}
    rng = np.random.default_rng(7)
    for k in SERVE_LANES:
        lanes = list(range(k))
        for name in BITMAP_LANE_SETS:
            values, active = _states(torch, levels, out_deg, V, k, name,
                                     rng)
            m_f = [int(x) for x in torch.where(active, out_deg, 0).sum(
                1, dtype=torch.int64).tolist()]
            touched = pe.push_lanes_touched(fe.row_src, fe.dst, active,
                                            lanes, num_rows=fe.num_rows)

            def flags(touched=touched):
                if words_route:
                    return {"block_words": eb.lane_block_words(
                        touched, pplan.owner8, lanes, GRID_ROWS)[0]}
                return {"block_live": pb.grid_block_live(
                    touched, pplan.owner8, GRID_ROWS),
                    "block_rows": GRID_ROWS}

            fl = flags()

            def skip(values=values, active=active, fl=fl):
                return eb.edge_block_fold_lanes(pplan, values, out_deg,
                                                active, lanes, **kw, **fl)

            def full(values=values, active=active):
                return eb.edge_block_fold_lanes(pplan, values, out_deg,
                                                active, lanes, **kw)

            args = (values, active, lanes, [True] * k, [], m_f)

            def step(args=args):
                return bitmap._lane_step(*args)

            def dense_step(args=args):
                return dense._lane_step(*args)

            res = skip()
            l1 = full()
            s_new, s_nxt, _ = step()
            d_new, d_nxt, _ = dense_step()
            row = {
                "narrow_lanes": sum(m <= caps[1] for m in m_f),
                "live_vertices": int(active.any(0).sum()),
                "2l_ms": _time_ms(torch, skip, reps=10),
                "2l_fold_device_ms": _device_ms(torch, skip, skip_kernel),
                "2l_prepass_device_ms": _device_ms(torch, skip,
                                                   "lanes_pack"),
                "flags_ms": _time_ms(torch, flags, reps=10),
                "flags_device_ms": _device_ms(torch, flags, ""),
                "1l_ms": _time_ms(torch, full, reps=10),
                "1l_fold_device_ms": _device_ms(torch, full,
                                                "edge_block_fold"),
                "step_ms": _time_ms(torch, step, reps=5, warmup=1),
                "step_device_ms": _device_ms(torch, step, "", calls=5),
                "dense_ms": _time_ms(torch, dense_step, reps=5, warmup=1),
                "dense_device_ms": _device_ms(torch, dense_step, "",
                                              calls=5),
                "hash": _digest(res[0], res[1], l1[0], l1[1], s_new, s_nxt,
                                d_new, d_nxt)}
            if not words_route:      # the flags' pack ran inside the fold
                row["flags_device_ms"] = (row["flags_device_ms"] or 0.0) + (
                    _device_ms(torch, skip, "lanes_flags_pack") or 0.0)
            if words_route and name == "bfs":
                row.update(_wide_routes(torch, eb, pplan, values, out_deg,
                                        active, touched, m_f, caps, kw))
            out[f"k{k}_{name}"] = row
            print(json.dumps({f"k{k}_{name}": row}), file=sys.stderr,
                  flush=True)
            del values, active, touched, fl, res, l1, s_new, s_nxt, d_new, \
                d_nxt
            torch.cuda.empty_cache()
    for k in SERVE_LANES:            # 1L's pre-pass on 50% frontiers
        gen = torch.Generator().manual_seed(50 + k)
        active = (torch.rand((k, V), generator=gen) < 0.5).to("cuda")
        values = torch.where(active, 0, INT_MAX).to(torch.int32)

        def prep(values=values, active=active):
            return eb.lanes_prepare(values, out_deg, active, list(range(k)),
                                    gather="plus_one")

        out[f"prepare50_k{k}"] = {
            "messages": "live" if words_route else "all",
            "ms": _time_ms(torch, prep, reps=10),
            "device_ms": _device_ms(torch, prep, "lanes_pack")}
        del active, values
    return out


def _wide_routes(torch, eb, pplan, values, out_deg, active, touched, m_f,
                 caps, kw):
    """The BFS set's wide lanes in the narrow lanes' launch (every bit of
    their words set) against a 1L launch of their own, both with the
    fills and pre-passes; their outputs must agree."""
    k = values.shape[0]
    narrow = [i for i in range(k) if m_f[i] <= caps[1]]
    wide = [i for i in range(k) if i not in narrow]
    if not narrow or not wide:
        return {"wide_lanes": len(wide)}

    def shared():
        words, _ = eb.lane_block_words(touched, pplan.owner8,
                                       list(range(k)), GRID_ROWS, wide=wide)
        return eb.edge_block_fold_lanes(pplan, values, out_deg, active,
                                        list(range(k)), **kw,
                                        block_words=words)

    def split():
        words, _ = eb.lane_block_words(touched, pplan.owner8, narrow,
                                       GRID_ROWS)
        red, got = eb.edge_block_fold_lanes(pplan, values, out_deg, active,
                                            narrow, **kw, block_words=words)
        return eb.edge_block_fold_lanes(pplan, values, out_deg, active,
                                        wide, **kw, red=red, got=got)

    a, b = shared(), split()
    if _digest(*a) != _digest(*b):
        raise SystemExit("the wide lanes' two routes disagree")
    return {"wide_lanes": len(wide),
            "shared_ms": _time_ms(torch, shared, reps=10),
            "shared_device_ms": _device_ms(torch, shared, "", calls=5),
            "split_ms": _time_ms(torch, split, reps=10),
            "split_device_ms": _device_ms(torch, split, "", calls=5)}


def build_tree(label: str) -> dict:
    """Build the tree's edge_block.cu and push_ell.cu; from the compiler's
    report, each reported kernel instantiation's registers and spill
    bytes (stores, loads)."""
    from repro_torch.kernels import _build
    _build.SOURCES = ("edge_block", "push_ell")
    rep = _build.build(ptxas_verbose=True)
    fn, kind, kernels = None, None, {}
    for text in rep["ptxas"].values():
        for ln in text.splitlines():
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1] if "'" in ln else ln
                kind = next((s for s in REPORTED if s in fn), None)
            elif fn is not None and kind is not None:
                entry = kernels.setdefault(fn, {"kind": kind})
                if "Used" in ln and "registers" in ln:
                    entry["registers"] = int(ln.split("Used")[1].split()[0])
                if "spill stores" in ln:
                    parts = ln.replace(",", "").split()
                    entry["spill_stores"] = int(
                        parts[parts.index("spill") - 2])
                    entry["spill_loads"] = int(
                        parts[len(parts) - 1 - parts[::-1].index("spill")
                              - 2])
    return {"tree": label, "seconds": rep["seconds"], "kernels": kernels}


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
    make_inputs()
    report = {"smi": smi, "inputs_s": time.perf_counter() - t0,
              "builds": [_ab.last_line(proc, f"build of {label}")
                         for label, proc in builds.items()]}
    for b in report["builds"]:
        print(json.dumps({"tree": b["tree"], "seconds": b["seconds"],
                          "kernels": {n: e for n, e in b["kernels"].items()
                                      if e.get("spill_stores")
                                      or e["kind"] in ("edge_block_skip_fold",
                                                       "words_kernel")}}),
              flush=True)
    report["runs"] = _ab.run_in_turns(__file__, tree_of)
    differ = _ab.differing(report["runs"])
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(report, f, indent=1)
    if differ:
        raise SystemExit(f"the trees' outputs differ at {differ}")
    print(json.dumps({"outputs_equal": sorted(
        k for k, v in report["runs"][0].items() if isinstance(v, dict)
        and "hash" in v)}), flush=True)


if __name__ == "__main__":
    main()
