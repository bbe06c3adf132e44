"""The harness is driven by data: a configuration, a traffic mix, a
metric, a driver and a kind of query added as new files (with their
entries in ``BENCHMARK.json``) in a copy of the benchmark are found by
name, and no file that was there is edited."""
from __future__ import annotations

import hashlib
import json

from bench.harness import cell
from bench.harness.spec import Spec
from conftest import tiny_copy


def _hashes(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench").rglob("*")) if p.is_file()}


def test_new_files_are_found_by_name_and_nothing_is_edited(tmp_path):
    root = tiny_copy(tmp_path / "checkout")
    before = _hashes(root)
    cfg = json.loads((root / "bench/configs/graph500-s21.json").read_text())
    cfg["scale"] = 7
    (root / "bench/configs/tiny-new.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "bench/traffic/bfs64.json").read_text())
    traffic["keys"] = 5
    (root / "bench/traffic/bfs5.json").write_text(json.dumps(traffic))
    (root / "bench/metrics/searches_in_window.py").write_text(
        "def read(rec):\n    return len(rec.searches) or None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny-new", "source": "a test", "reduced": ["scale"],
        "file": "bench/configs/tiny-new.json", "why": "a test"})
    bench["workloads"].append({
        "name": "tiny-new.bfs5", "config": "tiny-new", "traffic": "bfs5",
        "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "searches_in_window", "unit": "count", "better": "higher",
        "source": "host_clock", "layer": "run loop", "moves": "mteps",
        "workloads": ["tiny-new.bfs5"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    r = cell.run("tiny-new.bfs5", 3, 0.3, True, device="cpu",
                 spec=Spec(root))
    assert r["correct"] is True
    assert r["metrics"]["searches_in_window"]["value"] == r["attempted"]
    after = _hashes(root)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        p.relative_to(root) for p in (
            root / "bench/configs/tiny-new.json",
            root / "bench/traffic/bfs5.json",
            root / "bench/metrics/searches_in_window.py")}


# a kind of query: which vertices a search reaches, held against the
# bfs reference; its control is that reference one level short
REACH = """
import torch

from bench.reference import bfs

NUMBER = "reach_mismatch"
SAMPLE = 4


def combine(a, b):
    return a + b


def reading(ref, a):
    want = bfs.answer(ref, a.root) != bfs.UNREACHED
    return int((torch.as_tensor(a.value).to(ref.src.device) != want).sum())


def control(ref, a):
    return bfs.control(ref, a) != bfs.UNREACHED
"""

# a driver that answers it: the same bfs program, root after root
REACH_DRIVER = """
import time

import numpy as np

from bench.harness import deploy
from bench.harness.check import Answer
from bench.reference.bfs import UNREACHED


class Driver:
    def __init__(self, dep, traffic, seed, spans, sample):
        from repro_torch.core import dsl
        from repro_torch.core.translator import translate
        self.dep, self.sample = dep, sample
        rng = np.random.default_rng(seed)
        self.roots = [int(r) for r in rng.choice(
            np.flatnonzero(dep.degree > 0), int(traffic["roots"]))]
        self.prog = translate(dsl.bfs_program(UNREACHED), dep.graph,
                              deploy.schedule(dep.config["engine"]),
                              device=dep.device)

    def programs(self):
        return [self.prog]

    def window(self, seconds, spans, tracer, rec):
        t0 = time.perf_counter()
        for i, r in enumerate(self.roots):
            levels, _ = self.prog.run(roots=r)
            reached = levels != UNREACHED
            self.sample.offer("reach", lambda: Answer("reach", r, reached))
            rec.searches.append({"root": r, "edges": 1, "ms": 1.0,
                                 "supersteps": 1, "traced": False})
        rec.window_s = time.perf_counter() - t0
        rec.attempted = len(self.roots)

    def drain(self, grace_s):
        return 0
"""


def test_a_new_driver_and_kind_of_query_are_found_by_name(tmp_path):
    root = tiny_copy(tmp_path / "checkout")
    before = _hashes(root)
    cfg = json.loads((root / "bench/configs/graph500-s21.json").read_text())
    cfg["limits"] = {"reach_mismatch": 0, "unanswered": 0}
    (root / "bench/configs/tiny-reach.json").write_text(json.dumps(cfg))
    (root / "bench/traffic/reach6.json").write_text(
        json.dumps({"driver": "reach_searches", "roots": 6}))
    (root / "bench/drivers/reach_searches.py").write_text(REACH_DRIVER)
    (root / "bench/reference/reach.py").write_text(REACH)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny-reach", "source": "a test", "reduced": ["scale"],
        "file": "bench/configs/tiny-reach.json", "why": "a test"})
    bench["workloads"].append({
        "name": "tiny-reach.reach6", "config": "tiny-reach",
        "traffic": "reach6", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("tiny-reach.reach6")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    r = cell.run("tiny-reach.reach6", 4, 0.3, False, device="cpu",
                 spec=Spec(root), with_control=True)
    assert r["correct"] is True and r["attempted"] == 6
    assert r["checks"]["reach_mismatch"] == {"value": 0, "limit": 0}
    assert r["control"]["reach_mismatch"] > 0
    assert "mteps" in r["metrics"]
    after = _hashes(root)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        p.relative_to(root) for p in (
            root / "bench/configs/tiny-reach.json",
            root / "bench/traffic/reach6.json",
            root / "bench/drivers/reach_searches.py",
            root / "bench/reference/reach.py")}
