"""What the A/B scripts (``scripts/*_ab.py``) share: the card's name and
power limit, the trees to compare, and one timing process a tree run in
turns.

An A/B script times one piece of the port in two or more trees of its
``src/`` on one card: the parent's (``git archive <parent> src/repro_torch
| tar -x -C build/parent``), any extra trees, and this tree's.  The trees
run one process each, in the order parent, extras, this tree, then the
same backwards, so that a drift of the card's clocks or of its host over
the call shows as a difference between a tree's two runs.  Each process
runs the script again as ``script --time <label>`` with ``PYTHONPATH``
set to its tree and prints one JSON line last.  The timing itself is
``chip_smoke.py``'s (``_time_ms``, ``_device_ms``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them,
    printed."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    return smi


def trees(parent: str, extras=()) -> dict[str, str]:
    """Label -> ``src`` directory: ``parent``, each ``label=path`` of
    ``extras``, then this tree as ``change``."""
    out = {"parent": os.path.abspath(parent)}
    for item in extras:
        label, path = item.split("=", 1)
        out[label] = os.path.abspath(path)
    out["change"] = os.path.join(ROOT, "src")
    return out


def spawn(script: str, tree: str, *args) -> subprocess.Popen:
    """``script`` with ``args`` in a process of its own on ``tree``; its
    standard output piped, its errors passed on."""
    env = dict(os.environ, PYTHONPATH=tree)
    return subprocess.Popen([sys.executable, os.path.abspath(script), *args],
                            env=env, stdout=subprocess.PIPE, text=True)


def last_line(proc: subprocess.Popen, what: str, timeout=900) -> dict:
    """The JSON object a child printed last (all it printed is passed
    on); exits on a child that failed."""
    stdout, _ = proc.communicate(timeout=timeout)
    sys.stdout.write(stdout)
    sys.stdout.flush()
    if proc.returncode != 0:
        raise SystemExit(f"{what} failed (exit {proc.returncode})")
    return json.loads(stdout.strip().splitlines()[-1])


def run_in_turns(script: str, tree_of: dict[str, str]) -> list[dict]:
    """``script --time <label>`` once a tree in the order of ``tree_of``
    and then backwards, one at a time; the lines they printed last."""
    order = list(tree_of) + list(reversed(tree_of))
    return [last_line(spawn(script, tree_of[label], "--time", label),
                      f"timing of {label}") for label in order]


def differing(runs: list[dict]) -> list[str]:
    """The shapes whose rows' ``hash`` is not the same in every run."""
    hashes: dict[str, set] = {}
    for run in runs:
        for shape, row in run.items():
            if isinstance(row, dict) and "hash" in row:
                hashes.setdefault(shape, set()).add(row["hash"])
    return sorted(s for s, h in hashes.items() if len(h) > 1)
