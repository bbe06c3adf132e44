"""Port parity: the static analyzer over traced ATen graphs, the IR
verifier and structured diagnostics, against the JAX package.

Case for case with ``tests/test_analysis.py``: the same programs, written
in each package's DSL, go through ``repro.core.analysis`` (jaxprs) and
``repro_torch.core.analysis`` (``make_fx`` graphs), and the facts, their
provenance and the diagnostic codes are compared with the JAX package's
values rather than copied constants.  The adversarial programs (an apply
that is elementwise only on the probe batch, a gather that equals
``plus_one`` on it by coincidence) must be caught statically in both.

One divergence in the reference is routed around: under jax 0.9
``jnp.where`` stages a ``jit`` equation that the JAX analyzer's evaluator
does not descend (it lists ``pjit``), so an evaluation through
``jnp.where`` falls back to the probe there.  The coincidence program is
compared exactly in its ``lax.select`` spelling (the ``select_n`` that
``jnp.where`` wraps), and in its ``jnp.where`` spelling on every fact's
value and on the module fact's provenance.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from repro import lint as RL
from repro.core import analysis as RA
from repro.core import dsl as RD
from repro.core import graph as RG
from repro.core.scheduler import DirectionPolicy as RDP
from repro.core.scheduler import ScheduleConfig as RSC
from repro.core.translator import translate as rtranslate

import torch
from repro_torch import lint
from repro_torch.core import dsl
from repro_torch.core import graph as G
from repro_torch.core.analysis import (analysis_cache_clear, analyze_program,
                                       apply_is_elementwise,
                                       apply_preserves_identity,
                                       classify_gather,
                                       gather_absorbs_identity, verify_ir)
from repro_torch.core.diagnostics import (DIAGNOSTIC_CODES, Diagnostic,
                                          max_severity, render_table)
from repro_torch.core.ir import GatherOp, ReduceOp, lower_program
from repro_torch.core.passes import (GatherClassificationPass, Pass,
                                     PassContext, PassPipeline,
                                     default_pipeline)
from repro_torch.core.scheduler import DirectionPolicy, ScheduleConfig, plan
from repro_torch.core.translator import translate
from repro_torch.errors import (DiagnosticError, GraphValidationError,
                                IRVerificationError)
from repro_torch.kernels.ref import GATHER_OPS, WEIGHT_FREE_GATHERS

CPU = "cpu"
TEMPLATES = sorted(dsl.PROGRAM_TEMPLATES)
# the four properties the probe-only analyzer used to decide by sampling
PROBE_DECIDED = ("gather_module", "elementwise", "identity_fixpoint",
                 "identity_absorbing")


def _ctx(num_vertices=100, num_edges=1000):
    cfg = ScheduleConfig()
    return PassContext(schedule=cfg,
                       plan=plan(cfg, num_vertices=num_vertices,
                                 num_edges=num_edges),
                       use_kernels=False, num_vertices=num_vertices,
                       num_edges=num_edges)


@pytest.fixture(scope="module")
def graphs():
    src, dst = RG.rmat_edges(120, 900, seed=7)
    w = np.random.default_rng(7).uniform(0.5, 2.0, len(src)) \
        .astype(np.float32)
    return (RG.from_edge_list(src, dst, num_vertices=120, weights=w),
            G.from_edge_list(src, dst, num_vertices=120, weights=w))


def _pair(name):
    return RD.PROGRAM_TEMPLATES[name](), dsl.PROGRAM_TEMPLATES[name]()


def _codes(diags):
    return [d.code for d in diags]


def _programs(pkg, xp, where):
    """The adversarial and diagnostic programs of ``tests/test_analysis.py``
    in one package's DSL (``xp`` its array module, ``where`` its select)."""
    if xp is torch:
        flip = (lambda s: torch.flip(s, (0,)))
        total = torch.sum
    else:
        flip, total = jnp.flip, jnp.sum
    inf = float("inf")
    return {
        "evader": pkg.VertexProgram(
            name="evader", gather=lambda v, w, d: v + 1, reduce="min",
            apply=lambda old, s: where(total(old) > 1e6, flip(s),
                                       xp.minimum(old, s)),
            init_value=100.0, frontier="changed", value_dtype=xp.float32),
        "coincidence": pkg.VertexProgram(
            name="coincidence",
            gather=lambda v, w, d: where(v < 100, v + 1, v * 2),
            reduce="min", apply=xp.minimum, init_value=2**20,
            frontier="changed", value_dtype=xp.int32),
        "wrap": pkg.VertexProgram(
            name="wrap", gather=lambda v, w, d: v + 1, reduce="min",
            apply=xp.minimum, init_value=2**31 - 1, frontier="changed",
            value_dtype=xp.int32),
        "leaky": pkg.VertexProgram(
            name="leaky", gather=lambda v, w, d: v + w, reduce="min",
            apply=xp.minimum, init_value=inf, frontier="changed",
            mask_inactive=False, value_dtype=xp.float32),
    }


def _both(name, jax_where=jnp.where):
    return (_programs(RD, jnp, jax_where)[name],
            _programs(dsl, torch, torch.where)[name])


# ---------------------------------------------------------------------------
# 1. facts and provenance for every shipped template
# ---------------------------------------------------------------------------


def test_templates_cover_the_reference_templates():
    assert TEMPLATES == sorted(RD.PROGRAM_TEMPLATES)


@pytest.mark.parametrize("name", TEMPLATES)
def test_template_facts_equal_jax_and_all_static(name):
    ref, port = _pair(name)
    r, t = RA.analyze_program(ref), analyze_program(port)
    assert t.summary() == r.summary()
    for prop in PROBE_DECIDED + ("weight_use", "monotone"):
        assert t.summary()[prop][1] == "static", (prop, t.summary()[prop])
    assert _codes(t.diagnostics) == _codes(r.diagnostics)


@pytest.mark.parametrize("name", TEMPLATES)
def test_probe_static_agreement(name):
    """The sampling probes (the fallback tier) agree with the graph's
    verdicts on every template, and with the JAX package's probes."""
    ref, prog = _pair(name)
    facts = analyze_program(prog)
    dt = prog.value_dtype
    assert classify_gather(prog.gather, dt) == facts.gather_module.value \
        == RA.classify_gather(ref.gather, ref.value_dtype)
    assert apply_is_elementwise(prog.apply, dt) == facts.elementwise.value
    assert apply_preserves_identity(prog.apply, prog.reduce, dt) \
        == facts.identity_fixpoint.value
    assert gather_absorbs_identity(prog.gather, prog.reduce, dt) \
        == facts.identity_absorbing.value


# ---------------------------------------------------------------------------
# 2. WEIGHT_FREE_GATHERS is an oracle the analyzer re-derives
# ---------------------------------------------------------------------------


def test_analyzer_rederives_weight_free_menu():
    """``weight_use``, from graph liveness alone, partitions the menu as
    the pinned tuple does, however the user spells the gather."""
    menu = {
        "copy": lambda v, w, d: v,
        "plus_one": lambda v, w, d: 1 + v,
        "add_w": lambda v, w, d: w + v,
        "mul_w": lambda v, w, d: torch.mul(w, v),
        "div_deg": lambda v, w, d: v / torch.clamp_min(d, 1).to(v.dtype),
    }
    assert sorted(menu) == sorted(GATHER_OPS)
    derived = []
    for name, fn in menu.items():
        facts = analyze_program(dsl.VertexProgram(
            name=f"menu_{name}", gather=fn, reduce="min", apply=torch.minimum,
            init_value=100.0, frontier="changed", value_dtype=torch.float32))
        assert facts.gather_module.value == name
        assert facts.weight_use.provenance == "static"
        if facts.weight_use.value is False:
            derived.append(name)
    assert tuple(n for n in GATHER_OPS if n in derived) \
        == WEIGHT_FREE_GATHERS


# ---------------------------------------------------------------------------
# 3. adversarial probe evasion
# ---------------------------------------------------------------------------


def test_adversarial_apply_evades_probe_static_catches():
    """Elementwise on every probe batch, a cross-lane ``flip`` past a
    threshold: the probe passes, the graph walk sees the live ``flip``,
    A002 raises the alarm; facts and codes equal the JAX package's."""
    ref, prog = _both("evader")
    r, t = RA.analyze_program(ref), analyze_program(prog)
    assert apply_is_elementwise(prog.apply, torch.float32) is True  # fooled
    assert t.elementwise.value is False                              # caught
    assert t.elementwise.provenance == "static"
    assert t.monotone.value is False
    assert "A002" in _codes(t.diagnostics)
    assert t.summary() == r.summary()
    assert _codes(t.diagnostics) == _codes(r.diagnostics)


def test_adversarial_gather_coincidence_rejected():
    """Equal to ``plus_one`` on the probe batch, a different function: the
    signature match refuses the menu module (on the card the kernels
    would otherwise evaluate ``v + 1``)."""
    ref, prog = _both("coincidence", jax.lax.select)
    r, t = RA.analyze_program(ref), analyze_program(prog)
    assert classify_gather(prog.gather, torch.int32) == "plus_one"  # fooled
    assert t.gather_module.value is None                           # caught
    assert t.gather_module.provenance == "static"
    assert "A002" in _codes(t.diagnostics)
    assert t.summary() == r.summary()
    assert _codes(t.diagnostics) == _codes(r.diagnostics)


def test_coincidence_in_jnp_where_spelling():
    """The ``jnp.where`` spelling: every fact's value and the module
    fact's provenance equal the JAX package's; A002 in both (the JAX
    evaluator's probe fallback on ``jit`` adds its A001)."""
    ref, prog = _both("coincidence")
    r, t = RA.analyze_program(ref), analyze_program(prog)
    assert {k: v for k, (v, _) in t.summary().items()} == \
        {k: v for k, (v, _) in r.summary().items()}
    assert t.summary()["gather_module"] == r.summary()["gather_module"] \
        == (None, "static")
    assert "A002" in _codes(t.diagnostics) and "A002" in _codes(r.diagnostics)
    assert [c for c in _codes(r.diagnostics) if c != "A001"] \
        == _codes(t.diagnostics)


def test_untraceable_program_falls_back_to_probes():
    """A gather that needs concrete values cannot be traced on fake
    tensors: its facts degrade to ``probed`` with A001, as the JAX
    package's do on a concretization error."""
    def host_gather_t(v, w, d):
        if bool(v.sum() >= 0):       # data-dependent Python control flow
            return v + 1
        return v

    def host_gather_r(v, w, d):
        if bool(np.asarray(v).sum() >= 0):
            return v + 1
        return v

    kw = dict(name="opaque", reduce="min", init_value=2**20,
              frontier="changed")
    prog = dsl.VertexProgram(gather=host_gather_t, apply=torch.minimum,
                             value_dtype=torch.int32, **kw)
    ref = RD.VertexProgram(gather=host_gather_r, apply=jnp.minimum,
                           value_dtype=jnp.int32, **kw)
    t, r = analyze_program(prog), RA.analyze_program(ref)
    assert t.gather_module.provenance == "probed"
    assert t.gather_module.value == "plus_one"
    assert "A001" in _codes(t.diagnostics)
    assert t.summary() == r.summary()
    assert _codes(t.diagnostics) == _codes(r.diagnostics)


# ---------------------------------------------------------------------------
# 4. overflow analysis and the bfs construction guard
# ---------------------------------------------------------------------------


def test_wrap_program_gets_error_diagnostic():
    ref, prog = _both("wrap")
    diags = analyze_program(prog).diagnostics
    wrap = [d for d in diags if d.code == "A003"]
    assert wrap and wrap[0].severity == "error"
    assert "int32" in wrap[0].message
    assert _codes(diags) == _codes(RA.analyze_program(ref).diagnostics)


def test_bfs_program_rejects_wrapping_sentinel():
    for bad in (0, -1, 2**31 - 1, 2**40):
        with pytest.raises(GraphValidationError):
            dsl.bfs_program(int_max=bad)
    with pytest.raises(ValueError):
        dsl.bfs_program(int_max=2**31 - 1)
    assert dsl.bfs_program(int_max=2**20).init_value == 2**20


def test_safe_int_templates_carry_no_overflow_diag():
    for name in ("bfs", "wcc", "degree"):
        codes = _codes(analyze_program(dsl.PROGRAM_TEMPLATES[name]())
                       .diagnostics)
        assert "A003" not in codes, name


# ---------------------------------------------------------------------------
# 5. diagnostics through translate(): report plumbing and strict mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TEMPLATES)
def test_translation_diagnostics_equal_jax(name, graphs):
    rg, tg = graphs
    ref, prog = _pair(name)
    c = translate(prog, tg, device=CPU)
    assert _codes(c.report.diagnostics) == \
        _codes(rtranslate(ref, rg).report.diagnostics)
    for d in c.report.diagnostics:
        assert isinstance(d, Diagnostic) and d.code in DIAGNOSTIC_CODES


def test_strict_translation_rejects_warnings(graphs):
    _, tg = graphs
    with pytest.raises(DiagnosticError) as ei:
        translate(dsl.sssp_program(), tg, strict=True, device=CPU)
    assert _codes(ei.value.diagnostics) == ["A004"]
    c = translate(dsl.bfs_program(), tg, strict=True, device=CPU)
    assert c.report.diagnostics == ()


def test_quantized_float_add_exchange_flagged():
    for name in ("pagerank", "bfs"):
        ref, prog = _pair(name)
        t = lint.lint_program(prog, pes=2, message_dtype="int8")
        r = RL.lint_program(ref, pes=2, message_dtype="int8")
        assert _codes(t) == _codes(r)
        a006 = [d for d in t if d.code == "A006"]
        assert bool(a006) == (name == "pagerank")
        assert all(d.severity == "warning" for d in a006)


def test_mask_frontier_mismatch_flagged():
    ref, prog = _both("leaky")
    codes = _codes(lint.lint_program(prog))
    assert "A005" in codes
    assert codes == _codes(RL.lint_program(ref))


def test_pass_report_leads_with_diagnostics(graphs):
    _, tg = graphs
    c = translate(dsl.sssp_program(), tg, dump_passes=True, device=CPU)
    assert c.report.pass_report.startswith("-- diagnostics --")
    assert "A004" in c.report.pass_report
    assert "== program-analysis [analysis] (changed)" in c.report.pass_report


def test_facts_ride_the_ir_and_notes_mirror_them(graphs):
    _, tg = graphs
    c = translate(dsl.bfs_program(), tg, device=CPU)
    assert any(n.strip().startswith("; analysis: gather_module=")
               for n in c.report.ir_dump.splitlines())


def _notes(report):
    """The IR notes, without the pull-sweep note (its wording names each
    package's own path by design)."""
    return [n.strip() for n in report.ir_dump.splitlines()
            if n.strip().startswith(";")
            and not n.strip().startswith("; pull sweep:")]


@pytest.mark.parametrize("mode", ["pull", "push", "auto"])
def test_coincidence_translates_as_jax(mode):
    """On the CPU the coincidence program's report names no gather module,
    on the backend the JAX package picks, with the same notes; a
    150-vertex chain from 0 gives vertex 101 the value 200 in both."""
    V = 150
    src = np.arange(V - 1, dtype=np.int32)
    ref, prog = _both("coincidence", jax.lax.select)
    rc = rtranslate(ref, RG.from_edge_list(src, src + 1, num_vertices=V),
                    RSC(direction=RDP(mode=mode)))
    tc = translate(prog, G.from_edge_list(src, src + 1, num_vertices=V),
                   ScheduleConfig(direction=DirectionPolicy(mode=mode)),
                   device=CPU)
    assert tc.report.gather_module is None is rc.report.gather_module
    assert (rc.report.backend, tc.report.backend) == \
        ("sparse_xla", "sparse_torch")
    assert _notes(tc.report) == _notes(rc.report)
    rv, rit = rc.run(roots=0)
    tv, tit = tc.run(roots=0)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    assert int(tv[101]) == 200 and tit == int(rit)


# ---------------------------------------------------------------------------
# 6. analysis caching and the translate-time budget
# ---------------------------------------------------------------------------


def test_analysis_facts_are_cached_per_program():
    p = dsl.bfs_program()
    assert analyze_program(p) is analyze_program(p)
    before = analyze_program(p)
    analysis_cache_clear()
    after = analyze_program(p)
    assert after is not before
    assert after.summary() == before.summary()


def test_translate_breakdown_itemizes_analysis(graphs):
    _, tg = graphs
    p = dsl.bfs_program()
    analyze_program(p)                     # warm the fact cache
    c = translate(p, tg, device=CPU)
    bd = c.report.translate_breakdown
    assert "analysis_s" in bd
    assert bd["analysis_s"] <= 0.10 * bd["total_s"]
    bd2 = translate(p, tg, device=CPU).report.translate_breakdown
    assert bd2["preprocess_cached"] is True
    assert bd2["analysis_s"] < 0.01


# ---------------------------------------------------------------------------
# 7. the IR verifier between every pass pair
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TEMPLATES)
def test_verifier_clean_on_all_templates(name):
    ctx = _ctx()
    default_pipeline().run(lower_program(dsl.PROGRAM_TEMPLATES[name]()), ctx,
                           verify=True)
    assert not [d for d in ctx.diagnostics if d.code.startswith("V")]


def test_verify_ir_flags_corrupted_ir_directly():
    ir = lower_program(dsl.bfs_program())
    assert "V002" in _codes(verify_ir(ir.replace(ops=tuple(reversed(
        ir.ops)))))
    bad = ir.replace(ops=ir.ops + (ir.ops[0],))
    assert "V001" in _codes(verify_ir(bad))
    assert all(d.severity == "error" for d in verify_ir(bad))


class _CorruptIdentityPass(Pass):
    """Folds the wrong reduce identity: the seeded bug the verifier exists
    to catch at the pass boundary."""

    name = "corrupt-identity"
    kind = "transform"

    def run(self, ir, ctx):
        rop = ir.find(ReduceOp)
        return ir.replace_op(rop, ReduceOp(op=rop.op, identity=torch.tensor(
            0, dtype=ir.value_dtype)))


def test_verifier_fails_at_offending_pass_boundary():
    pipeline = PassPipeline([GatherClassificationPass(),
                             _CorruptIdentityPass()])
    with pytest.raises(IRVerificationError) as ei:
        pipeline.run(lower_program(dsl.bfs_program()), _ctx(), verify=True)
    assert ei.value.stage == "after corrupt-identity"
    assert _codes(ei.value.diagnostics) == ["V003"]
    assert "reduce_identity" in ei.value.diagnostics[0].message
    ir, _ = pipeline.run(lower_program(dsl.bfs_program()), _ctx(),
                         verify=False)
    assert int(ir.find(ReduceOp).identity) == 0


def test_verifier_catches_bogus_module_annotation():
    class EvilModule(Pass):
        name = "evil-module"

        def run(self, ir, ctx):
            gop = ir.find(GatherOp)
            return ir.replace_op(gop, GatherOp(fn=gop.fn, module="tan_w"))

    with pytest.raises(IRVerificationError) as ei:
        PassPipeline([EvilModule()]).run(
            lower_program(dsl.bfs_program()), _ctx(), verify=True)
    assert ei.value.stage == "after evil-module"
    assert _codes(ei.value.diagnostics) == ["V004"]


def test_lint_renders_a_table():
    d = Diagnostic("A004", "warning", "init", "msg", "fix")
    table = render_table([d], title="t:")
    assert table.splitlines()[0] == "t:"
    assert "A004" in table and "[fix]" in table
    assert max_severity([d]) == "warning"
    assert max_severity([]) is None
