"""A configuration deployed: its graph made from the seed and handed to
the program.

The configuration's generator (``bench/generators/<generator>.py``)
makes the tuples on the device; the benchmark keeps what its own
yardstick needs (component labels, tuples a component, degrees, the
directed edge list for the references) and gives the port the directed
edge list (every tuple both ways) through ``core/graph.from_edge_list``.
Everything the port builds from it is set-up.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import graph500


@dataclasses.dataclass
class Deployment:
    config: dict
    device: torch.device
    num_vertices: int
    src: np.ndarray              # (2m,) int32 directed edge list, host
    dst: np.ndarray
    wgt: np.ndarray | None       # (2m,) float32 or None
    vertex_tuples: np.ndarray    # (V,) tuples in each vertex's component
    degree: np.ndarray           # (V,) tuples at a vertex, self-loops aside
    bench_peak_bytes: int        # device peak of the benchmark's own set-up
    graph: object = None         # the port's Graph
    server: object = None        # the port's GraphServer, if one serves

    def edges_on(self, device):
        """The directed edge list on ``device`` for the references."""
        src = torch.from_numpy(self.src).to(device=device, dtype=torch.int64)
        dst = torch.from_numpy(self.dst).to(device=device, dtype=torch.int64)
        wgt = (None if self.wgt is None
               else torch.from_numpy(self.wgt).to(device))
        return src, dst, wgt


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def schedule(cfg: dict):
    """The port's ``ScheduleConfig`` from a configuration's ``schedule``."""
    from repro_torch.core.scheduler import ScheduleConfig
    return ScheduleConfig(**cfg.get("schedule", {}))


def build(config: dict, seed: int, device, spans, make) -> Deployment:
    """Make the graph from ``seed`` with the generator ``make`` and hand
    it to the port; start the server where the configuration deploys
    one."""
    from repro_torch.core import graph as G
    device = torch.device(device)
    n = 1 << int(config["scale"])
    u, v, w = make(config, seed, device)
    label = graph500.component_labels(u, v, n)
    vertex_tuples = graph500.component_tuples(u, label)[label]
    degree = graph500.degrees(u, v, n)
    dep = Deployment(
        config=config, device=device, num_vertices=n,
        src=torch.cat([u, v]).to(torch.int32).cpu().numpy(),
        dst=torch.cat([v, u]).to(torch.int32).cpu().numpy(),
        wgt=None if w is None else torch.cat([w, w]).cpu().numpy(),
        vertex_tuples=vertex_tuples.cpu().numpy(),
        degree=degree.cpu().numpy(), bench_peak_bytes=0)
    del u, v, w, label, vertex_tuples, degree
    if device.type == "cuda":
        dep.bench_peak_bytes = torch.cuda.max_memory_allocated(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    with spans.span("from_edge_list"):
        dep.graph = G.from_edge_list(dep.src, dep.dst, num_vertices=n,
                                     weights=dep.wgt)
    server = config["engine"].get("server")
    if server is not None:
        from repro_torch.core.scheduler import AdmissionPolicy
        from repro_torch.serve.graph_serve import GraphServer
        with spans.span("landmark_table"):
            dep.server = GraphServer(
                dep.graph, schedule=schedule(config["engine"]),
                admission=AdmissionPolicy(
                    slots=server["slots"],
                    slice_supersteps=server["slice_supersteps"]),
                landmarks=server["landmarks"], device=device,
                ppr_damping=server["ppr_damping"],
                ppr_iters=server["ppr_iters"])
    return dep


def release(dep: Deployment) -> None:
    """Drop everything the port holds, so the references run on a card
    the program no longer fills."""
    import gc

    from repro_torch.core import preprocess
    dep.graph = None
    dep.server = None
    preprocess.layout_cache_clear()
    gc.collect()
    if dep.device.type == "cuda":
        torch.cuda.empty_cache()


def layouts_s() -> float:
    """Host seconds the port spent building layouts, over every graph
    its layout cache holds (``GraphLayouts.stats()['build_times_s']``)."""
    from repro_torch.core import preprocess
    return sum(sum(entry.stats()["build_times_s"].values())
               for entry in preprocess._LAYOUT_CACHE.values())
