"""Port parity: the pass pipeline and the static analyzer against the JAX
package, for each of the seven DSL templates.

Flavor names map ``dense_pallas``→``dense_cuda``, ``dense_xla``→
``dense_torch`` and ``sparse_xla``→``sparse_torch``.  The one intended
difference: ``pull_sweep='auto'`` on the kernel path resolves dense by the
measured H100 walls (``passes.CUDA_AUTO_SWEEP_NOTE``), where the JAX
package resolves the bitmap plane under Pallas unmeasured.
"""
import pytest

import jax.numpy as jnp
from repro.core import analysis as RA
from repro.core import ir as RI
from repro.core import passes as RPS
from repro.core import scheduler as RS
from repro.core import dsl as RD
from repro.core import translator as RT

import torch
from repro_torch.core import analysis as TA
from repro_torch.core import dsl as TD
from repro_torch.core import ir as TI
from repro_torch.core import passes as TPS
from repro_torch.core import scheduler as TS
from repro_torch.core import translator as TT
from torch_threads import one_thread  # noqa: F401

TEMPLATES = sorted(TD.PROGRAM_TEMPLATES)
FLAVOR = {"dense_pallas": "dense_cuda", "dense_xla": "dense_torch",
          "sparse_xla": "sparse_torch"}
V, E = 1000, 8000


def _ref_ir(name, use_pallas, pull_sweep="auto", direction="auto"):
    cfg = RS.ScheduleConfig(pull_sweep=pull_sweep,
                            direction=RS.DirectionPolicy(mode=direction))
    ctx = RPS.PassContext(schedule=cfg,
                          plan=RS.plan(cfg, num_vertices=V, num_edges=E),
                          use_pallas=use_pallas, num_vertices=V,
                          num_edges=E)
    prog = RD.PROGRAM_TEMPLATES[name]()
    ir, _ = RPS.default_pipeline().run(RI.lower_program(prog), ctx,
                                       verify=True)
    return prog, ir


def _port_ir(name, use_kernels, pull_sweep="auto", direction="auto"):
    cfg = TS.ScheduleConfig(pull_sweep=pull_sweep,
                            direction=TS.DirectionPolicy(mode=direction))
    ctx = TPS.PassContext(schedule=cfg,
                          plan=TS.plan(cfg, num_vertices=V, num_edges=E),
                          use_kernels=use_kernels, num_vertices=V,
                          num_edges=E)
    prog = TD.PROGRAM_TEMPLATES[name]()
    ir, _ = TPS.default_pipeline().run(TI.lower_program(prog), ctx,
                                       verify=True)
    return prog, ir


def _summary(prog, ir, mod, translator):
    fstep = ir.find(mod.FusedSuperstepOp)
    fused = fstep.fused if fstep is not None \
        else ir.find(mod.FusedGatherReduceOp)
    push = ir.find(mod.PushScatterOp)
    return {
        "module": fused.gather.module,
        "direction": fused.direction,
        "backend": FLAVOR.get(ir.backend, ir.backend),
        "kernel": fused.kernel,
        "push_layout": push.layout if push is not None else None,
        "fused_superstep": fstep is not None,
        "touched_free": fstep.touched_free if fstep is not None else None,
        "pull_sweep": fstep.pull_sweep if fstep is not None else None,
        "frontier_dead": (fstep.frontier if fstep is not None
                          else ir.find(mod.FrontierUpdateOp)).dead,
        "message_mode": translator._flat_message_mode(
            ir, fused, prog, ir.value_dtype),
        "exchange": ir.find(mod.ExchangeOp) is not None,
    }


@pytest.mark.parametrize("name", TEMPLATES)
@pytest.mark.parametrize("kernels", [False, True])
def test_pipeline_decisions_match(name, kernels):
    # the kernel path is compared under pull_sweep='dense', where the two
    # packages agree; 'auto' is pinned separately below
    sweep = "dense" if kernels else "auto"
    rp, rir = _ref_ir(name, kernels, sweep)
    tp, tir = _port_ir(name, kernels, sweep)
    assert _summary(rp, rir, RI, RT) == _summary(tp, tir, TI, TT)


@pytest.mark.parametrize("name", TEMPLATES)
def test_analyzer_facts_match(name):
    """Every template's facts equal the JAX package's in value and
    provenance, all decided from the traced graph, with the same
    diagnostic codes."""
    ref = RA.analyze_program(RD.PROGRAM_TEMPLATES[name]())
    port = TA.analyze_program(TD.PROGRAM_TEMPLATES[name]())
    assert port.summary() == ref.summary()
    assert all(prov == "static" for _, prov in port.summary().values())
    assert [d.code for d in port.diagnostics] == \
        [d.code for d in ref.diagnostics]


@pytest.mark.parametrize("kernels", [False, True])
def test_auto_pull_sweep_resolves_dense(kernels):
    """'auto' resolves dense on the plain path (as the JAX package's XLA
    path) and on the kernel path, whose note carries the recorded H100
    walls; an explicit 'bitmap' is honored on both."""
    _, ir = _port_ir("bfs", kernels, "auto")
    assert ir.find(TI.FusedSuperstepOp).pull_sweep == "dense"
    if not kernels:
        assert any("plain PyTorch path" in n for n in ir.notes)
    else:
        assert any(TPS.CUDA_AUTO_SWEEP_NOTE in n for n in ir.notes)
    _, ir = _port_ir("bfs", kernels, "bitmap")
    assert ir.find(TI.FusedSuperstepOp).pull_sweep == "bitmap"


def test_degree_program_routes_like_pallas():
    """Unmatched weight-free gather: dense table sweep off the kernel
    path, sparse with the kernels on (as the Pallas routing does)."""
    for kernels, want in ((False, "dense_torch"), (True, "sparse_torch")):
        _, tir = _port_ir("degree", kernels)
        _, rir = _ref_ir("degree", kernels)
        assert tir.backend == want
        assert FLAVOR[rir.backend] == want


@pytest.mark.parametrize("direction", ["pull", "push"])
def test_direction_modes_match(direction):
    for name in ("bfs", "sssp", "pagerank"):
        rp, rir = _ref_ir(name, False, direction=direction)
        tp, tir = _port_ir(name, False, direction=direction)
        assert _summary(rp, rir, RI, RT) == _summary(tp, tir, TI, TT)


def test_probes_on_user_programs():
    """Probe verdicts on non-template callables match the JAX probes."""
    cases = [(lambda v, w, d: v * 2, torch.float32, jnp.float32),
             (lambda v, w, d: v + w + 1, torch.float32, jnp.float32),
             (lambda v, w, d: v - 1, torch.int32, jnp.int32)]
    for fn, tdt, jdt in cases:
        assert TA.classify_gather(fn, tdt) == RA.classify_gather(fn, jdt)
        assert TA.gather_absorbs_identity(fn, "min", tdt) == \
            RA.gather_absorbs_identity(fn, "min", jdt)
    for apply, tdt, jdt in [
            (lambda o, s: s, torch.float32, jnp.float32),
            (lambda o, s: o + s, torch.int32, jnp.int32),
            (lambda o, s: o / s.sum(), torch.float32, jnp.float32)]:
        assert TA.apply_is_elementwise(apply, tdt) == \
            RA.apply_is_elementwise(apply, jdt)
        assert TA.apply_preserves_identity(apply, "add", tdt) == \
            RA.apply_preserves_identity(apply, "add", jdt)


def test_weight_use_probe_rederives_weight_free_menu():
    """The analyzer's weight-use fact, from the gather graph's liveness,
    partitions the menu as the pinned tuple does."""
    from functools import partial
    from repro.kernels.ref import WEIGHT_FREE_GATHERS as REF_FREE
    from repro_torch.kernels.ref import GATHER_OPS, WEIGHT_FREE_GATHERS, \
        gather_msg
    assert WEIGHT_FREE_GATHERS == REF_FREE
    free = []
    for g in GATHER_OPS:
        facts = TA.analyze_program(TD.VertexProgram(
            name=f"menu_{g}", gather=partial(gather_msg, g), reduce="min",
            apply=torch.minimum, init_value=100.0, frontier="changed",
            value_dtype=torch.float32))
        assert facts.weight_use.provenance == "static"
        if facts.weight_use.value is False:
            free.append(g)
    assert tuple(free) == WEIGHT_FREE_GATHERS


def test_verify_ir_flags_broken_ir():
    import dataclasses
    _, ir = _port_ir("bfs", False)
    assert TA.verify_ir(ir) == []
    step = ir.find(TI.FusedSuperstepOp)
    broken = ir.replace_op(step, dataclasses.replace(step, touched_free=True,
                           frontier=dataclasses.replace(step.frontier,
                                                        mode="all")))
    assert {d.code for d in TA.verify_ir(broken)} >= {"V008"}


def test_plan_refuses_unported_planes():
    """Planes once refused until ported now resolve as the JAX package's
    plan does: several PEs (on a list of two CPU devices, as the JAX
    package's mesh over two of its host devices) and the partition
    axis."""
    tp = TS.plan(TS.ScheduleConfig(pes=2), num_vertices=10, num_edges=40,
                 devices=["cpu"] * 2)
    rp = RS.plan(RS.ScheduleConfig(pes=2), num_vertices=10, num_edges=40)
    assert tp.pes == rp.pes == 2
    assert tp.describe() == rp.describe()
    sp = TS.plan(TS.ScheduleConfig(partitions=2), num_vertices=10,
                 num_edges=40)
    rsp = RS.plan(RS.ScheduleConfig(partitions=2), num_vertices=10,
                  num_edges=40)
    assert sp.num_partitions == rsp.num_partitions == 2
    assert sp.describe() == rsp.describe()
    assert TS.push_capacity_tiers(5000) == RS.push_capacity_tiers(5000)
    assert TS.pull_block_capacities(777) == RS.pull_block_capacities(777)


def test_bfs_int_max_guard():
    from repro_torch.errors import GraphValidationError
    with pytest.raises(GraphValidationError):
        TD.bfs_program(2**31 - 1)
    assert TD.bfs_program().value_dtype == torch.int32
    assert TD.wcc_program().value_dtype == torch.int32
    ident = TD.reduce_identity("min", torch.int32)
    assert int(ident) == int(RD.reduce_identity("min", jnp.int32))
