"""End-to-end drift of the int8 exchange on sparse PageRank over R-MAT.

Runs PageRank (damping 0.85, 10 iterations: the settings of the JAX
package's ``test_quantized_exchange_pagerank_tolerance``) on a Graph500
R-MAT graph (edge factor 16, seed 0) at one PE and at ``--pes`` PEs with
the int8 wire format on the sparse plan's pull exchange, and prints, as
one JSON line, the largest ``|r_q - r_1|`` beside the heuristic bound
``d/(1-d) · pes · max|r_1|/127 + 1e-6`` that the JAX test pins on its
400-vertex graph.

``--impl port`` runs the PyTorch package (``devices=[device] * pes``).
``--impl jax`` is a witness that shares no code with the port: a numpy
PageRank whose per-superstep combine is the JAX package's own
``CommManager.quantized_psum`` under ``jax.vmap(axis_name="pe")``, over
the partial tables of each PE's slice of the reverse-COO chunks, cut as
the sharded pull plane cuts them (PE p takes chunks ``[p·k, (p+1)·k)``);
its ``r_1`` is the JAX package's ``algorithms.pagerank`` at one PE.  Each
mode imports one package only.

    PYTHONPATH=src python scripts/int8_pagerank_drift.py --impl port
    PYTHONPATH=src python scripts/int8_pagerank_drift.py --impl jax
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np

DAMPING, ITERS, PIPELINES = 0.85, 10, 8


def _summary(impl, scale, pes, r1, rq, extra):
    r1 = np.asarray(r1, np.float64)
    rq = np.asarray(rq, np.float64)
    delta = np.abs(rq - r1)
    bound = DAMPING / (1 - DAMPING) * pes * np.abs(r1).max() / 127 + 1e-6
    worst = int(delta.argmax())
    return {"impl": impl, "scale": scale, "pes": pes, "iters": ITERS,
            "max_abs_r1": float(np.abs(r1).max()),
            "max_abs_delta": float(delta.max()), "bound": float(bound),
            "within_bound": bool(delta.max() <= bound),
            "worst_vertex": worst, "r1_there": float(r1[worst]),
            "rq_there": float(rq[worst]), **extra}


def run_port(scale, pes, device):
    import torch
    from repro_torch.core import algorithms as alg
    from repro_torch.core import dsl
    from repro_torch.core import graph as G
    from repro_torch.core.scheduler import ScheduleConfig
    from repro_torch.core.translator import translate

    V = 1 << scale
    src, dst = G.rmat_edges(V, 16 * V, seed=0)
    g = G.from_edge_list(src, dst, num_vertices=V)
    dev = torch.device(device)
    r1, _, _ = alg.pagerank(g, iters=ITERS, damping=DAMPING, pes=1,
                            backend="sparse", device=dev)
    group = [dev] * pes
    rf, _, rep_f = alg.pagerank(g, iters=ITERS, damping=DAMPING, pes=pes,
                                backend="sparse", device=dev, devices=group)
    prog = translate(dsl.pagerank_program(DAMPING, ITERS), g,
                     ScheduleConfig(pes=pes, backend="sparse",
                                    message_dtype="int8"),
                     device=dev, devices=group)
    rq, _ = prog.run()
    assert rep_f.pes == prog.report.pes == pes
    assert prog.report.exchange_quantized
    r1, rf, rq = (t.cpu().numpy() for t in (r1, rf, rq))
    full = float((np.abs(rf - r1) / np.abs(r1).clip(1e-30)).max())
    return _summary("port", scale, pes, r1, rq,
                    {"device": str(dev), "E": int(g.num_edges),
                     "full_precision_max_rel": full})


def run_jax(scale, pes):
    import jax
    import jax.numpy as jnp
    from repro.core import algorithms as alg
    from repro.core import graph as G
    from repro.core import preprocess
    from repro.core.comm import CommManager

    V = 1 << scale
    src, dst = G.rmat_edges(V, 16 * V, seed=0)
    g = G.from_edge_list(src, dst, num_vertices=V)
    r1, _, _ = alg.pagerank(g, iters=ITERS, damping=DAMPING, pes=1,
                            backend="sparse")
    seg, esrc, _ = (np.asarray(a) for a in
                    preprocess.layouts_for(g).reverse_coo())
    E = seg.shape[0]
    nchunk = -(-PIPELINES // pes) * pes
    csize = max(1, math.ceil(E / nchunk))
    k = nchunk // pes
    cuts = [min(E, p * k * csize) for p in range(pes + 1)]
    deg = np.maximum(np.asarray(g.out_degrees), 1).astype(np.float32)
    combine = jax.jit(jax.vmap(
        lambda a: CommManager.quantized_psum(a, "pe", pes=pes),
        axis_name="pe"))

    def pagerank(quantized):
        r = np.ones(V, np.float32)
        for _ in range(ITERS):
            msg = r[esrc] / deg[esrc]
            parts = np.zeros((pes, V), np.float32)
            for p in range(pes):
                lo, hi = cuts[p], cuts[p + 1]
                np.add.at(parts[p], seg[lo:hi], msg[lo:hi])
            s = (np.asarray(combine(jnp.asarray(parts)))[0] if quantized
                 else parts.sum(0, dtype=np.float32))
            r = np.float32(1.0 - DAMPING) + np.float32(DAMPING) * s
        return r

    r1 = np.asarray(r1)
    plain = pagerank(False)
    rq = pagerank(True)
    full = float((np.abs(plain - r1) / np.abs(r1).clip(1e-30)).max())
    return _summary("jax", scale, pes, r1, rq,
                    {"E": int(E), "numpy_plain_vs_r1_max_rel": full})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", choices=("port", "jax"), required=True)
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--pes", type=int, default=2)
    ap.add_argument("--device", default="cpu",
                    help="the port's device (--impl port)")
    a = ap.parse_args(argv)
    out = (run_port(a.scale, a.pes, a.device) if a.impl == "port"
           else run_jax(a.scale, a.pes))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
