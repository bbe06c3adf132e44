"""Unfused bytes of one planned cell's trace, by ATen op.

    PYTHONPATH=src python scripts/plan_breakdown.py --arch whisper-large-v3 \\
        --shape train_card,448,8,train --microbatch 4 --top 8

Runs the cell's step once on ``meta`` (as ``launch.cells.trace_cell``) on a
(1, 1) mesh (``--grid`` for another) and prints the bytes each op name
moved (operands and results, as ``launch/costing.Tracker`` counts them)
with its share.  ``--shape`` is a key of ``configs.base.SHAPES`` or
``name,seq_len,global_batch,kind``.  No card needed.
"""
import argparse
import collections
import dataclasses

from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import cells as C
from repro_torch.launch import costing
from repro_torch.launch.mesh import make_mesh


class _ByOp(costing.Tracker):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.by_op = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.bytes
        out = super().__torch_dispatch__(func, types, args, kwargs)
        self.by_op[func.__name__] += self.bytes - before
        return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", required=True)
    p.add_argument("--grid", default="1,1")
    p.add_argument("--microbatch", type=int, default=0)
    p.add_argument("--top", type=int, default=8)
    args = p.parse_args(argv)
    if args.shape in SHAPES:
        shape = SHAPES[args.shape]
    else:
        name, seq, batch, kind = args.shape.split(",")
        shape = ShapeConfig(name, int(seq), int(batch), kind)
    cfg = get_config(args.arch)
    if args.microbatch:
        cfg = dataclasses.replace(cfg, microbatch_seqs=args.microbatch)
    grid = tuple(int(n) for n in args.grid.split(","))
    mesh = make_mesh(grid, ("data", "model"), "meta")
    cell = C.build_cell(args.arch, shape, mesh, cfg_override=cfg)
    inputs = cell.trace_inputs()        # as cells.trace_cell traces it
    tracker = _ByOp(arguments=[cell.model.param_tree(), inputs],
                    shard_fraction=C.shard_fractions(cell))
    with tracker:
        cell.fn(*inputs)
    total = sum(tracker.by_op.values())
    print(f"{args.arch} {shape} on {grid}: {total / 1e9:.2f} GB unfused")
    for name, n in tracker.by_op.most_common(args.top):
        print(f"  {name:32s} {n / 1e9:10.2f} GB  {n / total:.3f}")


if __name__ == "__main__":
    main()
