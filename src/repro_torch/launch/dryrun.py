"""Dry run: plan every (arch × shape × mesh) cell on the ``meta`` device.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell over 512 fake XLA host devices.  The port has no XLA: a cell's
parameters, optimizer state, caches and batch are abstract leaves with
resolved shardings (``models.param.AbstractLeaf``), and the step runs
once on ``meta`` tensors (``cells.trace_cell``).  Nothing is allocated:
no CUDA context, no host tensor beyond a few small index arrays.  The
production meshes are ``launch.mesh.make_production_mesh``'s (16, 16)
and (2, 16, 16) of H100s in hosts of 8.

What "per device" means without a partitioner, field by field:

* ``memory.argument_bytes`` — exact: the local bytes of every parameter,
  optimizer state, cache and batch leaf under its spec.
* ``memory.output_bytes`` / ``alias_bytes`` — the donated arguments
  (updated in place: the parameters and optimizer state of a train step,
  the cache of prefill and decode) count as outputs aliased to their
  inputs, plus the results the step makes (the metrics, the next tokens
  or the last logits).
* ``memory.temp_bytes`` — the peak of live non-argument bytes in the
  ``meta`` trace at the per-device batch (the global batch over the
  batch dim's resolved axes; one microbatch of a train step) and at full
  width; parameter-shaped buffers (gradients, their accumulators) at the
  parameters' shard sizes.  An upper bound wherever activations are
  ``model``-sharded.
* ``live_bytes_per_device`` = argument + output + temp − alias, and
  ``fits_80gb`` compares it with ``mesh.HBM_PER_DEVICE``.
* ``collective_ops`` — the plan's collectives by kind
  (``costing.collective_plan``).
* ``roofline`` (``--cost``, on (16, 16)) — ``costing``'s terms: FLOPs a
  perfect split of the traced step's, bytes unfused (a bound),
  collectives from the plan's formula (a bound), each over the H100's
  rate or the slowest link the collective's axes cross.
* ``params_count`` / ``active_params`` — exact, analytic.

Usage (any machine; no card needed):
  python -m repro_torch.launch.dryrun --arch mistral-nemo-12b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--cost] [--out f.json]
"""
from __future__ import annotations

import argparse
import gc
import json
import time
import traceback

from ..configs.base import SHAPES, ShapeConfig, cell_is_runnable
from ..configs.registry import ARCHS, get_config, optimized_config
from ..models.param import leaves
from . import cells as C
from . import costing
from .mesh import HBM_PER_DEVICE, axis_link, make_production_mesh


def _local_bytes(tree) -> int:
    return sum(leaf.local_nbytes for _, leaf in leaves(tree))


def _mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.devices.shape)


def plan_cell(cell: C.Cell, *, cost: bool, memo: dict | None = None
              ) -> dict:
    """The record's memory, collective and roofline fields of a built
    cell (see the module docstring); ``memo``: the traces' shared op
    memo."""
    rec: dict = {}
    arg_parts = {name: _local_bytes(a) for name, a in zip(
        _arg_names(cell), cell.args)}
    arg = sum(arg_parts.values())
    alias = sum(_local_bytes(cell.args[i]) for i in cell.donate)
    tr = C.trace_cell(cell, memo)
    out = alias + tr.new_output_bytes
    rec["trace_s"] = tr.seconds
    rec["memory"] = {"argument_bytes": arg, "output_bytes": out,
                     "temp_bytes": tr.peak_temp_bytes, "alias_bytes": alias,
                     "argument_parts": arg_parts}
    live = arg + out + tr.peak_temp_bytes - alias
    rec["live_bytes_per_device"] = int(live)
    rec["fits_80gb"] = bool(live <= HBM_PER_DEVICE)
    plan = costing.collective_plan(
        cell.cfg, cell.shape, cell.mesh, list(leaves(cell.args[0])),
        list(leaves(cell.model.param_specs())), n_micro=cell.n_micro,
        tokens_dev=cell.tokens_dev)
    rec["collective_ops"] = _counts(plan)
    rec["links"] = {a: axis_link(cell.mesh, a)[0]
                    for a in cell.mesh.axis_names}
    rec["params_count"] = cell.params_count
    rec["active_params"] = cell.active_params
    if cost:
        rec["roofline"] = _roofline(cell, tr, plan, memo)
    return rec


def _counts(plan: list[dict]) -> dict[str, int]:
    counts: dict[str, int] = {}
    for c in plan:
        counts[c["op"]] = counts.get(c["op"], 0) + c["count"]
    return counts


def _arg_names(cell: C.Cell) -> tuple[str, ...]:
    kind = cell.shape.kind
    if kind == "train":
        return ("params", "opt_state", "batch")
    if kind == "prefill":
        return (("params", "tokens", "enc_inputs", "cache")
                if cell.cfg.enc_dec else ("params", "tokens", "cache"))
    return ("params", "tokens_t", "cache")


def _roofline(cell: C.Cell, tr: C.Trace, plan: list[dict],
              memo: dict | None) -> dict:
    t0 = time.perf_counter()
    mesh = cell.mesh
    flops_unit, bytes_unit = tr.flops, tr.bytes
    opt_flops = opt_local = 0.0
    if cell.shape.kind == "train":
        st = cell.trace_inputs()[0]
        ot = costing.optimizer_trace(cell.model, C.opt_config(cell.cfg), st,
                                     memo)
        flops_unit -= ot.flops
        bytes_unit -= ot.bytes
        opt_flops = ot.flops
        params = list(leaves(cell.args[0]))
        opt_local = ot.bytes * (sum(p.local_nbytes for _, p in params)
                                / max(sum(p.nbytes for _, p in params), 1))
    flops_total = cell.n_micro * flops_unit * cell.batch_shards + opt_flops
    flops_dev = flops_total / mesh.size
    bytes_dev = cell.n_micro * bytes_unit + opt_local
    coll_dev = sum(c["bytes"] for c in plan)
    coll_s = costing.collective_time(mesh, plan)
    cr = costing.roofline(
        flops_dev=flops_dev, bytes_dev=bytes_dev, coll_dev=coll_dev,
        collective_s=coll_s, model_flops=cell.model_flops,
        flops_total=flops_total,
        trace_s=tr.seconds + time.perf_counter() - t0, counts=_counts(plan))
    return {
        "flops_dev": cr.flops_dev, "bytes_dev": cr.bytes_dev,
        "coll_dev": cr.coll_dev, "compute_s": cr.compute_s,
        "memory_s": cr.memory_s, "collective_s": cr.collective_s,
        "dominant": cr.dominant, "model_flops": cr.model_flops,
        "hlo_flops_total": cr.hlo_flops_total,
        "useful_ratio": cr.useful_ratio, "trace_s": round(cr.trace_s, 2),
        "collective_counts": cr.counts,
    }


def run_cell(arch: str, shape_name: str | ShapeConfig, *,
             multi_pod: bool = False, cost: bool = False,
             rule_overrides: dict | None = None, optimized: bool = False,
             mesh=None, cfg_override=None, memo: dict | None = None
             ) -> dict:
    """One cell's record.  ``mesh`` (default: the production mesh of
    ``multi_pod``) and ``cfg_override`` let a caller plan a cell of its
    own (the card's shapes on a (1, 1) mesh of ``cuda:0``); ``memo``:
    the traces' shared op memo."""
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    rec: dict = {"arch": arch, "shape": shape.name,
                 "mesh": _mesh_name(mesh)}
    if optimized:
        cfg = optimized_config(arch)
        rec["profile"] = "optimized"
    else:
        cfg = cfg_override or get_config(arch)
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        rec.update(status="skip", skip_reason=why)
        return rec
    try:
        t0 = time.perf_counter()
        cell = C.build_cell(arch, shape, mesh,
                            rule_overrides=rule_overrides, cfg_override=cfg)
        rec.update(plan_cell(cell, cost=cost, memo=memo))
        rec["plan_s"] = round(time.perf_counter() - t0, 2)
        del cell
        gc.collect()
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def summary_line(rec: dict) -> str:
    status = rec["status"]
    extra = ""
    if status == "ok":
        extra = (f" plan={rec['plan_s']}s "
                 f"live={rec['live_bytes_per_device'] / 1e9:.2f}GB "
                 f"fits_80gb={rec['fits_80gb']}")
        if "roofline" in rec:
            r = rec["roofline"]
            extra += (f" dom={r['dominant']}"
                      f" c/m/l={r['compute_s']:.4f}/{r['memory_s']:.4f}"
                      f"/{r['collective_s']:.4f}s"
                      f" useful={r['useful_ratio']:.2f}")
    elif status == "error":
        extra = " " + rec["error"][:160]
    return f"{rec['arch']} × {rec['shape']} × {rec['mesh']}: {status}{extra}"


def sweep(cells, *, cost: bool, optimized: bool = False, out=None,
          echo=print) -> list[dict]:
    """``run_cell`` over ``(arch, shape, multi_pod)`` triples; roofline
    terms only on (16, 16), as the JAX package's."""
    results = []
    memo: dict = {}
    for i, (a, s, m) in enumerate(cells):
        rec = run_cell(a, s, multi_pod=m, cost=cost and not m,
                       optimized=optimized, memo=memo)
        results.append(rec)
        echo(f"[{i + 1}/{len(cells)}] {summary_line(rec)}")
        if out:
            with open(out, "w") as f:
                json.dump(results, f, indent=1)
    return results


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--cost", action="store_true")
    p.add_argument("--optimized", action="store_true",
                   help="use the post-hillclimb profile")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or
                               (args.all and not args.multi_pod)) \
        else [args.multi_pod]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]
    t0 = time.perf_counter()
    results = sweep(cells, cost=args.cost, optimized=args.optimized,
                    out=args.out, echo=lambda line: print(line, flush=True))
    n = {k: sum(r["status"] == k for r in results)
         for k in ("ok", "skip", "error")}
    print(f"done: {n['ok']} ok, {n['skip']} skip, {n['error']} error in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return results


if __name__ == "__main__":
    main()
