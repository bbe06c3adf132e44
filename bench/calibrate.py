"""The readings that the limits of ``correct`` are set from.

    python3 bench/calibrate.py --workload <name> --seeds 11,12,13 \\
        --seconds 5 --out chiprun_out/calibrate.jsonl

Runs the cell once a seed in one process, each run as ``bench/run.py``
runs it (its own graph from the seed, set-up, a window at the cell's
load, the check), and beside the program's numbers the control's: the
plain reference put in the program's place one step of precision lower
(``bench/harness/check.py``).  One JSON line a seed goes to ``--out``
and to standard output.  The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench.harness import cell
    if not torch.cuda.is_available():
        print("calibration runs on the card", file=sys.stderr)
        return 2
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = cell.run(args.workload, seed, args.seconds, False,
                         device="cuda", with_control=True)
            line = json.dumps({
                "workload": args.workload, "seed": seed,
                "wall_s": time.perf_counter() - t0,
                "correct": r["correct"], "attempted": r["attempted"],
                "program": {k: c["value"] for k, c in r["checks"].items()},
                "control": r["control"], "metrics": r["metrics"],
                "device": r["device"]})
            print(line, flush=True)
            f.write(line + "\n")
            f.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
