#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

It takes no arguments and runs every phase, in order (any failure raises
and the script exits non-zero):

1. device  — the card's name and power limit (nvidia-smi), torch/CUDA.
2. build   — compile the CUDA kernels from ``src/repro_torch/csrc``.
3. kernels — each kernel against its plain PyTorch version over every
   gather × reduce × dtype × mask_inactive the menu admits, ragged shapes
   and NaN inputs: min, max and int32 exact, float add within
   ``rtol=1e-5`` (the kernel sums a row's lanes in slot order, the plain
   version in PyTorch's order).
4. main    — R-MAT at Graph500 scale 22 (edge factor 16, seed 0), BFS
   from root 0 through ``algorithms.bfs`` under pull, push and auto,
   held against a numpy level-synchronous BFS; the launch counts of both
   kernels over the auto run; each kernel held against its plain version
   at the main path's shapes and timed there (CUDA events, median of 30
   launches after warm-up) beside its bound; run wall, MTEPS and the cost
   of the one host sync per superstep.
5. others  — at scale 20: SSSP (push == pull exactly, ≈ scipy Dijkstra),
   WCC (= min vertex id per weak component, scipy), PageRank (20
   iterations, rtol 1e-4 of a scipy power iteration).

The line before the last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Longer logs go to ``chiprun_out/``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
INT_MAX = 2**30
SCALE = 22          # the main path's R-MAT (Graph500 scale, edge factor 16)
OTHERS_SCALE = 20   # SSSP, WCC and PageRank against scipy

# The H100 SXM's peak rates (NVIDIA data sheet), which the bounds assume:
# device-memory bandwidth, and the scalar (non-tensor-core) float32 rate,
# also used for int32 ops.
CARD = "H100 80GB HBM3"
_BANDWIDTH = 3.35e12
_SCALAR_OPS = 67e12


def log(*a):
    print(*a, flush=True)


def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    if CARD not in name:
        raise SystemExit(f"chip_smoke: the bounds assume an {CARD}, not "
                         f"{name!r}")
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"count {torch.cuda.device_count()} bandwidth_bound "
        f"{_BANDWIDTH:.3g} B/s")
    return {"smi": smi, "name": name}


def phase_build():
    from repro_torch.kernels import _build
    info = _build.build(ptxas_verbose=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for name, text in info["ptxas"].items():
            f.write(f"== {name}\n{text}\n")
    lines = [ln.strip() for text in info["ptxas"].values()
             for ln in text.splitlines()]
    regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
            if "registers" in ln and "Used " in ln]
    spills = sorted({ln.split(":")[-1].strip() for ln in lines
                     if "spill" in ln})
    log(f"[build] built {info['built']} in {info['seconds']:.2f} s: "
        f"{len(regs)} kernel instantiations, at most {max(regs or [0])} "
        f"registers a thread; spill lines {spills}")
    return info


def _same(a, b):
    """Exact agreement, NaN equal to NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        return bool(((a == b) | (a.isnan() & b.isnan())).all())
    return bool((a == b).all())


def _close(a, b, rtol=1e-5, atol=1e-6):
    """``|a - b| <= atol + rtol |b|`` elementwise; equal infs and NaNs
    agree."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    near = (a - b).abs() <= atol + rtol * b.abs()
    return bool((near | (a == b) | (a.isnan() & b.isnan())).all())


def _max_err(a, b):
    if a.dtype.is_floating_point:
        ok = ~(a.isnan() & b.isnan())
        d = (a[ok].double() - b[ok].double()).abs()
        return float(d.max()) if d.numel() else 0.0
    return float((a.long() - b.long()).abs().max()) if a.numel() else 0.0


def phase_kernels(torch):
    from repro_torch.kernels import edge_block as eb
    from repro_torch.kernels import push_ell as pe
    from repro_torch.kernels.ref import GATHER_OPS, PAD, REDUCE_OPS
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    checked = 0
    worst = {"edge_block": 0.0, "push_ell": 0.0}
    for R, W, V in ((1037, 8, 4099), (1, 8, 33), (300, 16, 97), (5, 1, 7)):
        nbr = rng.integers(0, V, (R, W)).astype(np.int32)
        nbr[rng.random((R, W)) < 0.3] = PAD
        wgt = rng.uniform(0, 4, (R, W)).astype(np.float32)
        deg = rng.integers(0, 9, V).astype(np.int32)
        act = rng.random(V) < 0.5
        for dtype in (np.int32, np.float32):
            for nan in ((False, True) if dtype == np.float32 else (False,)):
                vals = (rng.integers(-50, 50, V) if dtype == np.int32
                        else rng.uniform(-5, 5, V)).astype(dtype)
                if nan:
                    vals[rng.integers(0, V, max(V // 10, 1))] = np.nan
                t = [torch.as_tensor(a).to(dev)
                     for a in (nbr, wgt, vals, deg, act)]
                for gather in GATHER_OPS:
                    if gather == "div_deg" and dtype == np.int32:
                        continue
                    for reduce in REDUCE_OPS:
                        for mask in (True, False):
                            got = eb.edge_block_reduce(
                                *t, gather=gather, reduce=reduce,
                                mask_inactive=mask)
                            want = eb.edge_block_reduce_plain(
                                *t, gather=gather, reduce=reduce,
                                mask_inactive=mask)
                            torch.cuda.synchronize()
                            exact = not (dtype == np.float32
                                         and reduce == "add")
                            ok = (_same if exact else _close)(got[0], want[0])
                            if not ok or not _same(got[1], want[1]):
                                raise AssertionError(
                                    f"edge_block {gather}/{reduce}/"
                                    f"{dtype.__name__}/mask={mask}/nan={nan}"
                                    f" R={R} W={W} V={V}: max err "
                                    f"{_max_err(got[0], want[0])}")
                            worst["edge_block"] = max(
                                worst["edge_block"],
                                _max_err(got[0], want[0]))
                            checked += 1
                    src = torch.as_tensor(
                        rng.integers(0, V, R).astype(np.int32)).to(dev)
                    got = pe.push_ell_message_block(
                        t[0], t[1], src, t[2], t[3], gather=gather)
                    want = pe.push_ell_message_block_plain(
                        t[0], t[1], src, t[2], t[3], gather=gather)
                    torch.cuda.synchronize()
                    if not _same(got, want):
                        raise AssertionError(
                            f"push_ell {gather}/{dtype.__name__}/nan={nan} "
                            f"C={R} W={W}: max err {_max_err(got, want)}")
                    checked += 1
    log(f"[kernels] {checked} kernel/plain comparisons agree "
        "(min/max/int exact, float add rtol 1e-5); max abs err "
        f"{worst}")
    return worst


def _time_ms(torch, fn, reps=30, warmup=3):
    """Median CUDA-event milliseconds of ``reps`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _profile_run(torch, prog, run_wall_s, label):
    """Device time by op over one BFS run (torch.profiler), and the idle
    share of the unprofiled run wall that the kernels leave."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prog.run(roots=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prog.run(roots=0)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)
    top = [(e.key, round(e.self_device_time_total / 1e3, 4), e.count)
           for e in ops[:10]]
    idle = 1.0 - busy_ms / (1e3 * run_wall_s)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"profile_bfs_{label}.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    log(f"[profile] bfs {label}: kernel time {busy_ms:.3f} ms of the "
        f"{run_wall_s * 1e3:.2f} ms run wall (device idle share "
        f"{idle:.3f}); top ops by device ms (ms, calls): {top}")
    return {"kernel_ms": busy_ms, "idle_share": idle, "top_ops": top}


def numpy_bfs(offsets, dst, root, V):
    """Level-synchronous BFS on a CSR, independent of the port."""
    level = np.full(V, INT_MAX, np.int64)
    level[root] = 0
    frontier = np.array([root], np.int64)
    d = 0
    while frontier.size:
        starts, ends = offsets[frontier], offsets[frontier + 1]
        counts = ends - starts
        total = int(counts.sum())
        base = np.repeat(starts - np.concatenate([[0], np.cumsum(counts)[:-1]]),
                         counts)
        nb = dst[base + np.arange(total)]
        nb = np.unique(nb[level[nb] == INT_MAX])
        d += 1
        level[nb] = d
        frontier = nb
    return level


def phase_main(torch, dev_info):
    from repro_torch.core import algorithms as alg
    from repro_torch.core import dsl
    from repro_torch.core import graph as G
    from repro_torch.core.scheduler import DirectionPolicy, ScheduleConfig
    from repro_torch.core.translator import translate
    from repro_torch.kernels import edge_block as eb
    from repro_torch.kernels import push_ell as pe

    scale, device = SCALE, "cuda"
    V, E = 1 << scale, 16 << scale
    t0 = time.perf_counter()
    src, dst = G.rmat_edges(V, E, seed=0)
    g = G.from_edge_list(src, dst, num_vertices=V)
    del src, dst
    gen_s = time.perf_counter() - t0
    log(f"[main] R-MAT scale {scale}: V={V} E={g.num_edges} built in "
        f"{gen_s:.1f} s")
    offsets = g.edge_offsets.numpy().astype(np.int64)
    oracle = numpy_bfs(offsets, g.edges_dst.numpy(), 0, V)

    results = {}
    for direction in ("pull", "push", "auto"):
        eb.edge_block_reduce.launches = 0
        pe.push_ell_message_block.launches = 0
        t1 = time.perf_counter()
        levels, iters, rep = alg.bfs(g, root=0, direction=direction,
                                     device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = {"edge_block": eb.edge_block_reduce.launches,
                    "push_ell": pe.push_ell_message_block.launches}
        lv = levels.cpu().numpy()
        if not np.array_equal(lv.astype(np.int64), oracle):
            raise AssertionError(f"bfs {direction} disagrees with the numpy "
                                 f"oracle at {int((lv != oracle).sum())} "
                                 "vertices")
        results[direction] = (lv, iters, rep, launches, wall)
        log(f"[main] bfs {direction}: iters={iters} backend={rep.backend} "
            f"translate_s={rep.translate_time_s:.2f} "
            f"breakdown={json.dumps({k: round(v, 3) if isinstance(v, float) else v for k, v in rep.translate_breakdown.items()})} "
            f"launches={launches} run_stats={json.dumps(rep.run_stats)}")
    ref = results["pull"][0]
    for direction in ("push", "auto"):
        if not np.array_equal(results[direction][0], ref):
            raise AssertionError(f"bfs {direction} != bfs pull")
    auto_launches = results["auto"][3]
    if min(auto_launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the auto run: "
                             f"{auto_launches}")

    # steady-state run wall (layouts cached, kernels loaded), per mode
    traversed = alg.traversed_edges(g, results["auto"][0])
    perf = {}
    for direction in ("pull", "push", "auto"):
        prog = translate(dsl.bfs_program(INT_MAX), g, ScheduleConfig(
            direction=DirectionPolicy(mode=direction)), device=device)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            prog.run(roots=0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        w = float(np.median(walls))
        iters = results[direction][1]
        perf[direction] = {"run_wall_s": w, "iters": iters,
                           "ms_per_superstep": 1e3 * w / iters,
                           "mteps": traversed / w / 1e6}
        log(f"[main] bfs {direction} steady: run wall {w * 1e3:.2f} ms, "
            f"{iters} supersteps, {1e3 * w / iters:.3f} ms/superstep, "
            f"MTEPS {traversed / w / 1e6:.1f} (traversed {traversed}) "
            f"on {dev_info['smi']}")
    # the one host sync per superstep: the occupancy read on its own
    active = torch.zeros(V, dtype=torch.bool, device=device)
    active[:: 97] = True
    sync_ms = _time_ms(torch, lambda: prog._occupancy(active), reps=50)
    log(f"[main] host sync (occupancy read) {sync_ms:.4f} ms per superstep; "
        f"auto run: {sync_ms * results['auto'][1]:.3f} ms of "
        f"{perf['auto']['run_wall_s'] * 1e3:.2f} ms")
    for direction in ("pull", "auto"):
        perf[direction]["profile"] = _profile_run(
            torch, translate(dsl.bfs_program(INT_MAX), g, ScheduleConfig(
                direction=DirectionPolicy(mode=direction)), device=device),
            perf[direction]["run_wall_s"], direction)

    # each kernel at the main path's shapes: kernel vs plain, then timed
    from repro_torch.core import preprocess
    lay = preprocess.layouts_for(g)
    pplan = lay.on(lay.pull_plan(64), device)
    fe = lay.on(lay.forward_ell(8), device)
    out_deg = g.out_degrees.to(device=device, dtype=torch.int32)
    values = torch.as_tensor(results["auto"][0]).to(device)
    rng = np.random.default_rng(1)
    act = torch.as_tensor(rng.random(V) < 0.5).to(device)
    kw = dict(gather="plus_one", reduce="min", mask_inactive=True)
    args = (pplan.flat_dst, pplan.flat_wgt, values, out_deg, act)
    got = eb.edge_block_reduce(*args, **kw)
    want = eb.edge_block_reduce_plain(*args, **kw)
    torch.cuda.synchronize()
    if not (_same(got[0], want[0]) and _same(got[1], want[1])):
        raise AssertionError("edge_block disagrees with plain at main shape")
    eb_err = _max_err(got[0], want[0])
    R8, W = pplan.flat_dst.shape
    eb_ms = _time_ms(torch, lambda: eb.edge_block_reduce(*args, **kw))
    eb_plain = _time_ms(torch, lambda: eb.edge_block_reduce_plain(*args, **kw),
                        reps=20)
    # bytes the function must move for bfs's gather: ids, the value and
    # frontier tables, the two outputs (weights and degrees are not read)
    eb_bytes = R8 * W * 4 + V * 4 + V * 1 + R8 * 4 + R8 * 1
    eb_ops = 2 * R8 * W
    eb_bound = 1e3 * max(eb_bytes / _BANDWIDTH, eb_ops / _SCALAR_OPS)

    from repro_torch.core.scheduler import push_capacity_tiers
    tiers = push_capacity_tiers(fe.num_rows)
    C = tiers[-1]
    rows = fe.rows_per_vertex.long()
    frontier = torch.zeros(V, dtype=torch.bool, device=device)
    order = torch.as_tensor(rng.permutation(V)).to(device)
    cum = torch.cumsum(rows[order], 0)
    frontier[order[cum <= C]] = True
    live = frontier[fe.row_src.long()]
    sel, ok = pe.compact_rows(live, fe.num_rows, C)
    sel = sel.long()
    dst_blk = torch.where(ok[:, None], fe.dst[sel], 2**31 - 1)
    wgt_blk, src_blk = fe.weights[sel].contiguous(), fe.row_src[sel]
    pargs = (dst_blk, wgt_blk, src_blk, values, out_deg)
    got = pe.push_ell_message_block(*pargs, gather="plus_one")
    want = pe.push_ell_message_block_plain(*pargs, gather="plus_one")
    torch.cuda.synchronize()
    if not _same(got, want):
        raise AssertionError("push_ell disagrees with plain at main shape")
    pe_err = _max_err(got, want)
    pe_ms = _time_ms(torch, lambda: pe.push_ell_message_block(
        *pargs, gather="plus_one"))
    pe_plain = _time_ms(torch, lambda: pe.push_ell_message_block_plain(
        *pargs, gather="plus_one"), reps=20)
    # source ids, one source value per row, the messages out
    pe_bytes = C * 4 + C * 4 + C * W * 4
    pe_bound = 1e3 * max(pe_bytes / _BANDWIDTH, C * W / _SCALAR_OPS)

    kernels = [
        {"name": "edge_block_reduce", "route": "cuda",
         "source": "src/repro_torch/csrc/edge_block.cu",
         "replaces": "src/repro/kernels/edge_block.py:33",
         "launches": auto_launches["edge_block"], "max_abs_err": eb_err,
         "ms": eb_ms, "plain_ms": eb_plain, "bound_ms": eb_bound,
         "bound_by": "bytes" if eb_bytes / _BANDWIDTH
         >= eb_ops / _SCALAR_OPS else "operations",
         "library_ms": None, "shape": [R8, W, V]},
        {"name": "push_ell_message_block", "route": "cuda",
         "source": "src/repro_torch/csrc/push_ell.cu",
         "replaces": "src/repro/kernels/push_ell.py:89",
         "launches": auto_launches["push_ell"], "max_abs_err": pe_err,
         "ms": pe_ms, "plain_ms": pe_plain, "bound_ms": pe_bound,
         "bound_by": "bytes", "library_ms": None, "shape": [C, W, V]},
    ]
    for k in kernels:
        log(json.dumps({"kernel": k["name"], "ms": k["ms"],
                        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                        "launches_per_bfs": k["launches"],
                        "shape": k["shape"]}))
    summary = {"scale": scale, "V": V, "E": g.num_edges,
               "graph_build_s": gen_s, "traversed_edges": traversed,
               "perf": perf, "host_sync_ms": sync_ms,
               "launches": {d: r[3] for d, r in results.items()},
               "run_stats": {d: r[2].run_stats for d, r in results.items()},
               "translate_breakdown": results["pull"][2].translate_breakdown,
               "card": dev_info["smi"]}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_main.json"), "w") as f:
        json.dump({"summary": summary, "kernels": kernels}, f, indent=1,
                  default=str)
    return kernels


def phase_others(torch):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components, dijkstra
    from repro_torch.core import algorithms as alg
    from repro_torch.core import graph as G

    scale, device = OTHERS_SCALE, "cuda"
    V, E = 1 << scale, 16 << scale
    src, dst = G.rmat_edges(V, E, seed=1)
    w = np.random.default_rng(2).uniform(1.0, 10.0, len(src)) \
        .astype(np.float32)
    g = G.from_edge_list(src, dst, num_vertices=V, weights=w)
    off = g.edge_offsets.numpy()
    A = sp.csr_matrix((g.edge_weights.numpy().astype(np.float64),
                       g.edges_dst.numpy(), off), shape=(V, V))

    d_pull, _, _ = alg.sssp(g, 0, direction="pull", device=device)
    d_push, it, rep = alg.sssp(g, 0, direction="push", device=device)
    if not torch.equal(d_pull, d_push):
        raise AssertionError("sssp push != pull")
    want = dijkstra(A, indices=0)
    got = d_push.cpu().numpy().astype(np.float64)
    if not (np.array_equal(np.isinf(got), np.isinf(want)) and np.allclose(
            got[np.isfinite(want)], want[np.isfinite(want)], rtol=1e-5)):
        raise AssertionError("sssp disagrees with scipy dijkstra")
    log(f"[others] sssp scale {scale}: {it} supersteps, push == pull, "
        f"allclose(rtol=1e-5) to scipy dijkstra; run_stats "
        f"{json.dumps(rep.run_stats)}")

    labels, it, _ = alg.wcc(g, device=device)
    n, comp = connected_components(A, directed=True, connection="weak")
    mins = np.full(n, V, np.int64)
    np.minimum.at(mins, comp, np.arange(V))
    if not np.array_equal(labels.cpu().numpy(), mins[comp]):
        raise AssertionError("wcc labels disagree with scipy components")
    log(f"[others] wcc: {it} supersteps, {n} components, labels = min id "
        "per scipy weak component")

    ranks, it, _ = alg.pagerank(g, iters=20, device=device)
    deg = np.maximum(np.diff(off), 1).astype(np.float64)
    ones = sp.csr_matrix((np.ones(g.num_edges), g.edges_dst.numpy(), off),
                         shape=(V, V))
    r = np.ones(V)
    for _ in range(20):
        r = 0.15 + 0.85 * (ones.T @ (r / deg))
    if not np.allclose(ranks.cpu().numpy(), r, rtol=1e-4):
        raise AssertionError("pagerank disagrees with scipy power iteration")
    log(f"[others] pagerank: {it} iterations within rtol 1e-4 of scipy")


def main():
    if len(sys.argv) > 1:
        raise SystemExit("usage: python3 chip_smoke.py (no arguments)")
    t0 = time.perf_counter()
    import torch
    dev_info = phase_device(torch)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    phase_build()
    phase_kernels(torch)
    kernels = phase_main(torch, dev_info)
    phase_others(torch)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(f"{dev_info['smi']}")
    log(json.dumps({"kernels": [{k: v for k, v in kern.items()
                                 if k != "shape"} for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
