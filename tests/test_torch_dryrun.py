"""The port's planning layer (``repro_torch.launch.{cells,costing,
dryrun}``): the cell arithmetic against the JAX package's, the dry run's
records (exact argument bytes, the collective plan counted by hand), the
``meta`` trace's counts, and that a production cell allocates nothing
but ``meta`` tensors."""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax

import repro.core  # noqa: F401  (the JAX package's import order)
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import cell_is_runnable as jcell_is_runnable
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import optimized_config as joptimized_config
from repro.configs.registry import smoke_config as jsmoke_config
from repro.launch import cells as JC
from repro.models import param as jparam
from repro.models.model import LModel as JLModel
from repro.sharding import partition as jps
from repro.train import optimizer as JO

from repro_torch.configs.base import SHAPES, ShapeConfig, cell_is_runnable
from repro_torch.configs.registry import (ARCHS, OPTIMIZED_OVERRIDES,
                                          get_config, optimized_config,
                                          smoke_config)
from repro_torch.kernels import _build
from repro_torch.kernels import decode_gqa as dg
from repro_torch.kernels import edge_block as eb
from repro_torch.kernels import push_ell as pe
from repro_torch.kernels import segment_sum as ss
from repro_torch.launch import cells as C
from repro_torch.launch import costing, dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import param as P
from repro_torch.models.model import LModel
from repro_torch.sharding import partition as ps
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import make_train_step

from torch_threads import one_thread  # noqa: F401


class _StandIn(jax.sharding.AbstractMesh):
    @property
    def devices(self):
        return np.empty(self.axis_sizes, dtype=object)


# ---------------------------------------------------------------------------
# the cell arithmetic against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cell_arithmetic_matches_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert C.param_counts(cfg) == JC.param_counts(jcfg)
    for name, shape in SHAPES.items():
        assert C.analytic_model_flops(cfg, shape) == \
            JC.analytic_model_flops(jcfg, JSHAPES[name])
        assert cell_is_runnable(cfg, shape) == \
            jcell_is_runnable(jcfg, JSHAPES[name])
    got, want = optimized_config(arch), joptimized_config(arch)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name != "dtype":
            assert g == w, f.name
    assert C.opt_config(cfg).algorithm == JC.opt_config(jcfg).algorithm
    assert C.opt_config(cfg).state_dtype == JC.opt_config(jcfg).state_dtype


def test_shapes_and_overrides_are_the_jax_package_s():
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    from repro.configs.registry import OPTIMIZED_OVERRIDES as J
    assert OPTIMIZED_OVERRIDES == J
    for kind in ("train", "prefill", "decode"):
        assert C.rules_for(kind, {"seq": ()}) == JC.rules_for(
            kind, {"seq": ()})


@pytest.mark.parametrize("arch", ["qwen3-8b", "grok-1-314b"])
def test_abstract_state_matches_jax(arch):
    """AdamW's m/v follow the parameters' shardings; Adafactor's factored
    states are replicated (grok)."""
    mesh = make_production_mesh()
    jmesh = _StandIn((16, 16), ("data", "model"))
    cfg = get_config(arch)
    model = LModel(cfg, device="meta")
    jmodel = JLModel(jget_config(arch))
    st = O.abstract_state(C.opt_config(cfg),
                          model.abstract_params(mesh, ps.TRAIN_RULES))
    jst = JO.abstract_state(JC.opt_config(jget_config(arch)),
                            jmodel.abstract_params(jmesh, jps.TRAIN_RULES))
    got = list(P.leaves(st))
    flat, _ = jax.tree_util.tree_flatten_with_path(jst)
    assert len(got) == len(flat)
    for (path, g), (jpath, w) in zip(got, flat):
        assert "/".join(map(str, path)) == "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in jpath)
        assert g.shape == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        spec = w.sharding.spec if w.sharding is not None else ()
        assert tuple(g.sharding.spec) == tuple(spec), path


# ---------------------------------------------------------------------------
# the dry run's records
# ---------------------------------------------------------------------------

TRAIN_T = ShapeConfig("t", 16, 8, "train")
DECODE_T = ShapeConfig("t", 32, 8, "decode")


def _jax_local_bytes(tree, info, rules, fsdp):
    """Local bytes of a JAX annotated tree under the JAX resolver."""
    total = 0
    for a in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
            x, jparam.Annotated)):
        spec = jps.resolve(a.shape, a.logical_axes, info, rules, fsdp=fsdp)
        n = math.prod(a.shape)
        for item in spec:
            for ax in ((item,) if isinstance(item, str) else (item or ())):
                n //= info.axis_sizes[ax]
        total += n * np.dtype(a.dtype).itemsize
    return total


@pytest.mark.parametrize("grid", [(1, 1), (2, 4)])
def test_run_cell_train_argument_bytes_are_exact(grid):
    cfg = smoke_config("qwen3-8b")
    mesh = make_mesh(grid, ("data", "model"), "meta")
    rec = dryrun.run_cell("qwen3-8b", TRAIN_T, mesh=mesh, cfg_override=cfg,
                          cost=True)
    assert rec["status"] == "ok", rec.get("traceback")
    jspecs = JLModel(jsmoke_config("qwen3-8b")).param_specs()
    info = jps.MeshInfo(dict(zip(("data", "model"), grid)))
    params = _jax_local_bytes(jspecs, info, jps.TRAIN_RULES, True)
    # AdamW: m and v in float32 with the parameters' shardings, the step
    rep = {"data": grid[0], "model": grid[1]}
    f32 = jax.tree.map(lambda a: dataclasses.replace(a, dtype=np.float32),
                       jspecs, is_leaf=lambda x: isinstance(
                           x, jparam.Annotated))
    state = 2 * _jax_local_bytes(f32, info, jps.TRAIN_RULES, True) + 4
    batch = 2 * TRAIN_T.global_batch * TRAIN_T.seq_len * 4 // rep["data"]
    parts = rec["memory"]["argument_parts"]
    assert parts == {"params": params, "opt_state": state, "batch": batch}
    assert rec["memory"]["argument_bytes"] == params + state + batch
    # donated: the parameters and the state, updated in place; the new
    # results: loss, grad norm and lr
    assert rec["memory"]["alias_bytes"] == params + state
    assert rec["memory"]["output_bytes"] == params + state + 12
    assert rec["live_bytes_per_device"] == (
        params + state + batch + 12 + rec["memory"]["temp_bytes"])
    assert rec["memory"]["temp_bytes"] > 0 and rec["fits_80gb"]
    r = rec["roofline"]
    assert r["flops_dev"] > 0 and r["bytes_dev"] > 0
    assert r["dominant"] in ("compute", "memory", "collective")
    if grid == (1, 1):
        assert rec["collective_ops"] == {} and r["coll_dev"] == 0
        assert r["collective_s"] == 0


def test_collective_plan_counted_by_hand_on_2x4():
    """qwen3-8b at smoke width (2 layers, D 64, 4 heads of 16, 1 kv head,
    F 128, vocab 512, bf16) on a (2, 4) (data, model) mesh.  No dim reaches
    the FSDP minimum of 1024, so nothing is gathered.

    Decode (8 × 32, DECODE_RULES: embed → data, heads/ffn/vocab → model;
    4 slots a device, one token each; ring all-reduce 2(n−1)/n · X):
      wq, wk, wv contract embed (data, n=2) into 16 local features:
        X = 4 · 16 · 2 = 128, sent 128, × 2 layers: 256 each → 768;
      wo and w_down contract heads / ffn (model, n=4) into 32 features:
        X = 4 · 32 · 2 = 256, sent 384, × 2 layers: 768 each → 1536;
      w_up, w_gate contract embed (data) into 32 features: sent 256 × 2
        layers: 512 each → 1024;
      the tied unembedding contracts embed (data) into 128 of the 512
        logits: X = 4 · 128 · 2 = 1024, sent 1024; the last logits
        gathered over model: 3/4 · 4 · 512 · 2 = 3072.
      Sum 768 + 1536 + 1024 + 1024 + 3072 = 7424.
    Train (8 × 16, 2 sequences a microbatch: 4 microbatches, 1 sequence
    of 16 tokens a device; 3 passes; TRAIN_RULES: heads/ffn/vocab →
    model, nothing on data but the batch):
      wo and w_down: X = 16 · 64 · 2 = 2048, sent 3072, × 2 layers × 3
        passes × 4 microbatches: 73728 each → 147456;
      gradients, float32, all-reduced over data (n=2, sent = X) every
        microbatch: model-local elements wq, wk, wv, wo 2048 each, w_up,
        w_gate, w_down 4096 each, the embedding 8192, ln1, ln2 128 each,
        q_norm, k_norm 32 each, the final norm 64: 29056 · 4 bytes × 4
        = 464896;
      the vocab-sharded logits: 3 all-reduces of 16 float32 (sent 96)
        × 2 × 4 = 2304, and the (16, 64) bf16 input gradient (sent 3072)
        × 4 = 12288.
      Sum 147456 + 464896 + 2304 + 12288 = 626944."""
    mesh = make_mesh((2, 4), ("data", "model"), "meta")
    cfg = smoke_config("qwen3-8b")
    for shape, want in ((DECODE_T, 7424), (TRAIN_T, 626944)):
        cell = C.build_cell("qwen3-8b", shape, mesh, cfg_override=cfg)
        plan = costing.collective_plan(
            cfg, shape, mesh, list(P.leaves(cell.args[0])),
            list(P.leaves(cell.model.param_specs())), n_micro=cell.n_micro,
            tokens_dev=cell.tokens_dev)
        assert sum(c["bytes"] for c in plan) == want, shape.kind
    # a (1, 1) mesh moves nothing
    one = make_mesh((1, 1), ("data", "model"), "meta")
    for shape in (DECODE_T, TRAIN_T):
        cell = C.build_cell("qwen3-8b", shape, one, cfg_override=cfg)
        assert costing.collective_plan(
            cfg, shape, one, list(P.leaves(cell.args[0])),
            list(P.leaves(cell.model.param_specs())), n_micro=cell.n_micro,
            tokens_dev=cell.tokens_dev) == []


def test_ep_psum_replaces_the_expert_gather_in_the_plan():
    """moonshot's optimized profile (moe_impl='shardmap') plans an N·D
    psum a MoE layer; the baseline gathers the E·C·D expert outputs."""
    mesh = make_mesh((2, 4), ("data", "model"), "meta")
    base = dataclasses.replace(smoke_config("moonshot-v1-16b-a3b"),
                               n_experts=8)
    kinds = {}
    for impl in ("gather", "shardmap"):
        cfg = dataclasses.replace(base, moe_impl=impl)
        cell = C.build_cell("moonshot-v1-16b-a3b", DECODE_T, mesh,
                            cfg_override=cfg)
        plan = costing.collective_plan(
            cfg, DECODE_T, mesh, list(P.leaves(cell.args[0])),
            list(P.leaves(cell.model.param_specs())), n_micro=1,
            tokens_dev=cell.tokens_dev)
        kinds[impl] = {c["what"].split(" blocks")[0]: c["bytes"]
                       for c in plan if "w_down" in c["what"]}
    L, D = base.n_layers, base.d_model
    # 4 slots × D bf16, all-reduced over model (n=4), a layer
    assert kinds["shardmap"]["ep psum"] == L * 1.5 * 4 * D * 2
    assert "moe combine" in kinds["gather"]
    assert "ep psum" not in kinds["gather"]


class _HostAllocations(TorchDispatchMode):
    """The largest tensor an op made anywhere but on ``meta``."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.largest = max(self.largest,
                                   t.numel() * t.element_size())
        return out


@pytest.mark.parametrize("arch,shape", [("qwen3-8b", "decode_32k"),
                                        ("gemma3-4b", "train_4k")])
def test_production_cell_allocates_only_meta_tensors(arch, shape):
    """A (16, 16) cell with its roofline: no tensor off ``meta`` above
    1 MB (the limit stated for the dry run: no host tensor beyond small
    index arrays)."""
    with _HostAllocations() as seen:
        rec = dryrun.run_cell(arch, shape, cost=True)
    assert rec["status"] == "ok", rec.get("traceback")
    assert seen.largest <= 1 << 20
    assert rec["links"] == {"data": "network", "model": "network"}
    r = rec["roofline"]
    assert r["flops_dev"] == pytest.approx(r["hlo_flops_total"] / 256)


def test_dryrun_main_writes_records(tmp_path):
    out = tmp_path / "f.json"
    recs = dryrun.main(["--arch", "falcon-mamba-7b", "--shape", "long_500k",
                        "--both-meshes", "--cost", "--out", str(out)])
    assert [r["status"] for r in recs] == ["ok", "ok"]
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert "roofline" in recs[0] and "roofline" not in recs[1]
    assert json.loads(out.read_text())[0]["arch"] == "falcon-mamba-7b"
    skip = dryrun.run_cell("qwen3-8b", "long_500k")
    assert skip["status"] == "skip"


# ---------------------------------------------------------------------------
# the meta trace and the model on meta
# ---------------------------------------------------------------------------


def test_tracker_counts_flops_bytes_and_the_live_peak():
    a = torch.zeros(4, 8, device="meta")
    w = torch.zeros(8, 16, device="meta")
    tr = costing.Tracker(arguments=[a, w], shard_fraction={(32, 32): 0.25})
    with tr:
        b = a @ w                          # 2·4·8·16 FLOPs, 256 bytes
        c = b + 1                          # 256 bytes more
        del b
        d = c.view(64)                     # a view: no bytes, no storage
        g = torch.zeros(32, 32, device="meta")   # a parameter's shape
    assert tr.flops == 2 * 4 * 8 * 16
    # b and c (512) until b goes, then c and g at a quarter (256 + 1024)
    assert tr.peak == 256 + 1024
    assert tr.live == 256 + 32 * 32 * 4 // 4
    assert tr.bytes == (128 + 512 + 256) + (256 + 256) + 4096
    del c, d, g
    assert tr.live == 0


def test_tracker_flops_equal_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode
    cfg = smoke_config("qwen3-8b")
    model = LModel(cfg, device="meta")
    cache = model.init_cache(2, 16)
    tok = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    with FlopCounterMode(display=False) as fc:
        model.decode_step(tok, cache)
    tr = costing.Tracker(arguments=[model.param_tree(), cache])
    with tr:
        model.decode_step(tok, cache)
    assert tr.flops == fc.get_total_flops() > 0


def test_model_on_meta_draws_nothing():
    cfg = get_config("grok-1-314b")
    model = LModel(cfg, device="meta")
    assert {t.device.type for t in model.param_leaves()} == {"meta"}
    assert sum(t.numel() for t in model.param_leaves()) == P.count(
        model.param_specs())
    spec_leaves = list(P.leaves(model.param_specs()))
    assert [tuple(t.shape) for t in model.param_leaves()] == [
        a.shape for _, a in spec_leaves]


def test_grad_specs_are_recorded_and_change_nothing():
    cfg = dataclasses.replace(smoke_config("qwen3-8b"), dtype="float32")
    batch = {"tokens": torch.randint(0, 512, (4, 8),
                                     generator=torch.Generator()
                                     .manual_seed(0)).to(torch.int32)}
    batch["labels"] = batch["tokens"].roll(-1, 1)
    ocfg = O.OptConfig(peak_lr=1e-3, warmup_steps=0)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = []
    for gs in (None, P.specs(LModel(cfg, device="meta").param_specs(), mesh,
                             ps.TRAIN_RULES)):
        model = LModel(cfg, device="cpu", dtype=torch.float32)
        step = make_train_step(model, ocfg, grad_specs=gs)
        assert step.grad_specs is gs
        state = O.init_state(ocfg, model.param_tree())
        step(state, batch)
        out.append(model.param_leaves())
    for a, b in zip(*out):
        assert torch.equal(a.detach(), b.detach())


def test_meta_inputs_never_reach_the_kernel_loader(monkeypatch):
    """Each wrapper takes its plain version's shapes on ``meta`` and never
    loads the CUDA extension (nothing runs there)."""
    def boom(*a, **k):
        raise AssertionError("the CUDA extension's loader was reached")

    monkeypatch.setattr(_build, "library", boom)

    def m(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    i32 = torch.int32
    out = dg.decode_gqa(m(2, 1, 4, 16), m(2, 8, 1, 16), m(2, 8, 1, 16),
                        m(2, 8, dtype=i32), m(2, dtype=i32), softcap=30.0)
    assert out.device.type == "meta" and tuple(out.shape) == (2, 1, 4, 16)
    out = ss.segment_reduce(m(10, dtype=i32), m(10), 4, reduce="min")
    assert out.device.type == "meta" and tuple(out.shape) == (4,)
    red, live = eb.edge_block_reduce(
        m(6, 8, dtype=i32), m(6, 8), m(10), m(10, dtype=i32),
        m(10, dtype=torch.bool), gather="add_w", reduce="min")
    assert tuple(red.shape) == (6,) and live.dtype == torch.bool
    msg = pe.push_ell_message_block(m(3, 8, dtype=i32), m(3, 8),
                                    m(3, dtype=i32), m(10), m(10, dtype=i32),
                                    gather="add_w")
    assert msg.device.type == "meta" and tuple(msg.shape) == (3, 8)
