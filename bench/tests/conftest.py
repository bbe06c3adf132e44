"""Shared set-up of the benchmark's CPU tests: the checkout's root and
``src`` on the path, torch on one thread (the workers share the cores),
and a copy of the benchmark's data at a size a test run holds."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_SCALE = 8          # 256 vertices, 4,096 tuples


@pytest.fixture(autouse=True)
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_copy(dest: Path, scale: int = TINY_SCALE) -> Path:
    """``BENCHMARK.json`` and the benchmark's files found by name under
    ``dest``, every configuration cut to ``scale``; returns ``dest``."""
    (dest / "bench").mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    for d in ("configs", "traffic", "metrics", "drivers", "reference",
              "generators"):
        shutil.copytree(ROOT / "bench" / d, dest / "bench" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for f in (dest / "bench" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["scale"] = scale
        f.write_text(json.dumps(c))
    return dest


@pytest.fixture(autouse=True)
def short_grace(monkeypatch):
    """A query that is never answered is given up on after 2 s, not a
    minute (the tiny graphs answer the rest in milliseconds)."""
    from bench.harness import cell
    monkeypatch.setattr(cell, "GRACE_S", 2.0)


@pytest.fixture
def tiny_spec(tmp_path):
    from bench.harness.spec import Spec
    return Spec(tiny_copy(tmp_path / "checkout"))
