"""Find a cell's parts by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics.
A cell's configuration is the file its entry names; its traffic mix is
``bench/traffic/<traffic>.json``.  Code is found by name as well:

- ``bench/generators/<generator>.py``, the ``generator`` a configuration
  names, with ``make(config, seed, device)``;
- ``bench/drivers/<driver>.py``, the ``driver`` a traffic mix names, with
  a class ``Driver``;
- ``bench/reference/<kind>.py``, a kind of query a driver answers, with
  its plain reference and the reading that compares an answer with it
  (``bench/harness/check.py``);
- ``bench/metrics/<metric name>.py``, each metric's reader, with
  ``read(record)`` that returns a number or ``None`` when it finds
  nothing to read.

Adding a configuration, a mix, a driver, a kind of query or a metric
adds files and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


class Spec:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules: dict = {}

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads(
            (self.root / "bench" / "traffic" / f"{name}.json").read_text())

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        ones: those whose ``workloads`` list it, or that list none."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]

    def module(self, folder: str, name: str):
        """``bench/<folder>/<name>.py``, loaded once."""
        path = self.root / "bench" / folder / f"{name}.py"
        if path not in self._modules:
            if not path.is_file():
                raise KeyError(f"no {folder} {name!r}: {path} is missing")
            spec = importlib.util.spec_from_file_location(
                f"bench_{folder}_" + re.sub(r"\W", "_", name), path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._modules[path] = module
        return self._modules[path]

    def generator(self, name: str):
        return self.module("generators", name).make

    def driver(self, name: str):
        return self.module("drivers", name).Driver

    def kind(self, name: str):
        return self.module("reference", name)

    def reader(self, metric: str):
        return self.module("metrics", metric).read
