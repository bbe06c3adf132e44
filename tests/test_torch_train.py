"""Port parity: the optimizers, the microbatched train step and the MoE
gradients against the JAX package, at smoke size in float32.

The optimizer cases are ``test_train_substrate.py``'s, each also run
through the JAX function on the same numpy inputs: updates agree within
``rtol=1e-6`` (both compute in float32, one operation at a time; the
reductions of the clipping norm and of Adafactor's factors sum in other
orders).  The port's updates are in place, so each call gets its own
copy of the trees.  A train step agrees with the JAX one within
``rtol=1e-5`` in its loss and metrics and ``rtol=2e-5, atol=1e-6`` in
every parameter and state leaf, with float32 gradient accumulators on
both sides (grok's config accumulates in bf16, where a sum rounds the
frameworks' last-bit differences to whole bf16 steps, 0.4–0.8% of a
gradient; ``test_loss_decreases`` runs that config as it is).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.models import moe as RM
from repro.train import optimizer as RO
from repro.train.train_loop import make_train_step as jax_train_step

import torch
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import convert
from repro_torch.models import moe as M
from repro_torch.models.model import LModel
from repro_torch.models.param import leaves, map_tree
from repro_torch.train import optimizer as O
from repro_torch.train.train_loop import (make_eval_step, make_train_step,
                                          microbatches)

from test_torch_loss_grads import batch, models
from torch_threads import one_thread  # noqa: F401


def _t(tree):
    return map_tree(lambda a: torch.as_tensor(np.array(a)), tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _same_trees(got, want, rtol=1e-6, atol=0.0):
    """Leaf for leaf: the same paths, shapes and dtypes and values."""
    want = dict(leaves(jax.tree.map(np.asarray, want)))
    got = dict(leaves(convert.params_to_jax(got)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].shape == w.shape and got[path].dtype == w.dtype, \
            path
        np.testing.assert_allclose(got[path], w, rtol=rtol, atol=atol,
                                   err_msg=str(path))


def _both(fn_name, cfg_kw, p, g, grad_scale=1.0):
    """One update through the port and the JAX package on copies of the
    same numpy trees: ``(port (params, state, metrics), jax (...))``."""
    tcfg, jcfg = O.OptConfig(**cfg_kw), RO.OptConfig(**cfg_kw)
    tp = _t(p)
    tout = getattr(O, fn_name)(tcfg, tp, _t(g), O.init_state(tcfg, tp),
                               grad_scale)
    jp = _j(p)
    jout = getattr(RO, fn_name)(jcfg, jp, _j(g), RO.init_state(jcfg, jp),
                                grad_scale)
    return tout, jout


def test_adamw_matches_manual_reference_and_jax():
    kw = dict(peak_lr=1e-2, warmup_steps=0, decay_steps=10**9,
              min_lr_ratio=1.0, weight_decay=0.0, clip_norm=1e9)
    p = {"w": np.asarray([1.0, -2.0, 3.0], np.float32)}
    g = {"w": np.asarray([0.1, 0.2, -0.3], np.float32)}
    (newp, st, _), (jp, jst, _) = _both("adamw_update", kw, p, g)
    gw = g["w"].astype(np.float64)
    mh = 0.1 * gw / (1 - 0.9)
    vh = 0.05 * gw * gw / (1 - 0.95)
    ref = p["w"] - 1e-2 * mh / (np.sqrt(vh) + 1e-8)
    np.testing.assert_allclose(newp["w"].numpy(), ref, rtol=1e-5)
    _same_trees(newp, jp)
    _same_trees(st, jst)
    assert int(st["step"]) == 1 and st["step"].dtype == torch.int32


def test_grad_clipping():
    kw = dict(clip_norm=1.0, peak_lr=1.0, warmup_steps=0, decay_steps=10**9,
              min_lr_ratio=1.0, weight_decay=0.0)
    p = {"w": np.zeros(4, np.float32)}
    g = {"w": np.full(4, 100.0, np.float32)}
    (newp, _, m), (jp, _, jm) = _both("adamw_update", kw, p, g)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    assert float(m["grad_norm"]) == float(jm["grad_norm"])
    _same_trees(newp, jp)


def test_grad_scale_equivalence():
    """update(g, grad_scale=1/M) == update(g/M), and both equal JAX's."""
    p = {"w": np.asarray([1.0, 2.0], np.float32)}
    g = {"w": np.asarray([4.0, -8.0], np.float32)}
    (a, _, _), (ja, _, _) = _both("adamw_update", {}, p,
                                  {"w": g["w"] / 4})
    (b, _, _), (jb, _, _) = _both("adamw_update", {}, p, g, 0.25)
    np.testing.assert_allclose(a["w"].numpy(), b["w"].numpy(), rtol=1e-6)
    _same_trees(a, ja)
    _same_trees(b, jb)


def test_adafactor_state_is_factored_and_matches_jax():
    kw = dict(algorithm="adafactor")
    p = {"w": np.random.default_rng(0).normal(size=(8, 16)).astype(
        np.float32), "b": np.zeros((16,), np.float32)}
    g = {"w": np.random.default_rng(1).normal(size=(8, 16)).astype(
        np.float32), "b": np.ones((16,), np.float32)}
    st = O.init_state(O.OptConfig(**kw), _t(p))
    assert st["vr"]["w"].shape == (8,) and st["vc"]["w"].shape == (16,)
    assert st["vr"]["b"].shape == (16,) and st["vc"]["b"].shape == ()
    (newp, nst, m), (jp, jst, jm) = _both("adafactor_update", kw, p, g)
    assert newp["w"].shape == (8, 16)
    assert np.isfinite(newp["w"].numpy()).all()
    _same_trees(newp, jp)
    _same_trees(nst, jst)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)


@pytest.mark.parametrize("algorithm", ["adamw", "adafactor"])
def test_big_stacked_leaf_updates_slice_by_slice(algorithm):
    """A stacked leaf over 2^24 elements goes slice by slice over its
    first axis, as in the JAX package (Adafactor's update clipping is then
    per slice): the same update as JAX's, with bf16 states for AdamW."""
    rng = np.random.default_rng(2)
    shape = (2, 2048, 4097)
    assert np.prod(shape) > 1 << 24
    p = {"w": rng.normal(size=shape).astype(np.float32)}
    g = {"w": rng.normal(size=shape).astype(np.float32)}
    kw = dict(algorithm=algorithm, warmup_steps=0, state_dtype="bfloat16"
              if algorithm == "adamw" else "float32")
    name = f"{algorithm}_update"
    (newp, nst, _), (jp, jst, _) = _both(name, kw, p, g)
    _same_trees(newp, jp, rtol=1e-6, atol=1e-7)
    if algorithm == "adamw":
        assert nst["m"]["w"].dtype == torch.bfloat16
        for key in ("m", "v"):
            np.testing.assert_allclose(
                nst[key]["w"].float().numpy(),
                np.asarray(jst[key]["w"].astype(jnp.float32)),
                rtol=1e-2, err_msg=key)
    else:
        _same_trees(nst, jst, rtol=1e-5)


def test_lr_schedule_matches_jax():
    kw = dict(peak_lr=1.0, warmup_steps=10, decay_steps=110,
              min_lr_ratio=0.1)
    tcfg, jcfg = O.OptConfig(**kw), RO.OptConfig(**kw)
    assert float(O.lr_at(tcfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(O.lr_at(tcfg, torch.tensor(10))) == pytest.approx(
        1.0, rel=1e-3)
    assert float(O.lr_at(tcfg, torch.tensor(10**6))) == pytest.approx(0.1)
    for s in (0, 1, 5, 9, 10, 11, 37, 60, 109, 110, 500):
        np.testing.assert_allclose(
            float(O.lr_at(tcfg, torch.tensor(s, dtype=torch.int32))),
            float(RO.lr_at(jcfg, jnp.asarray(s, jnp.int32))), rtol=1e-6)


def test_microbatch_reshape():
    cfg = dataclasses.replace(smoke_config("qwen3-8b"), microbatch_seqs=2)
    mbs, M_ = microbatches(cfg, {"tokens": torch.zeros((6, 8))})
    assert M_ == 3 and tuple(mbs["tokens"].shape) == (3, 2, 8)


@pytest.mark.parametrize("arch", ["qwen3-8b", "grok-1-314b"])
def test_train_step_matches_jax(arch):
    """One train step (2 microbatches of 2) against the JAX step: qwen3-8b
    with AdamW, grok-1-314b with its Adafactor; the parameters' dtypes
    and shapes kept."""
    jm, params, model = models(arch, microbatch_seqs=2,
                               grad_accum_dtype="float32")
    cfg = model.cfg
    kw = dict(warmup_steps=2, decay_steps=10, algorithm=cfg.optimizer,
              state_dtype=cfg.opt_state_dtype)
    b = batch(cfg, B=4)
    jocfg = RO.OptConfig(**kw)
    jp, jst, jmet = jax.jit(jax_train_step(jm, jocfg))(
        params, RO.init_state(jocfg, params),
        {k: jnp.asarray(v) for k, v in b.items()})
    tocfg = O.OptConfig(**kw)
    st = O.init_state(tocfg, model.param_tree())
    st, met = make_train_step(model, tocfg)(
        st, {k: torch.as_tensor(v) for k, v in b.items()})
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=1e-5, err_msg=key)
    _same_trees(model.param_tree(), jp, rtol=2e-5, atol=1e-6)
    _same_trees(st, jst, rtol=2e-5, atol=1e-6)


def test_microbatch_equivalence():
    """M microbatches of b == one batch of M·b (the JAX package's
    ``test_microbatch_equivalence``): the same loss and parameters."""
    out = []
    for mb in (2, 4):
        cfg = dataclasses.replace(smoke_config("qwen3-8b"), dtype="float32",
                                  microbatch_seqs=mb)
        model = LModel(cfg, device="cpu", dtype=torch.float32,
                       generator=torch.Generator().manual_seed(0))
        ocfg = O.OptConfig(warmup_steps=0, decay_steps=10**9)
        st = O.init_state(ocfg, model.param_tree())
        st, met = make_train_step(model, ocfg)(
            st, {k: torch.as_tensor(v)
                 for k, v in batch(cfg, B=4, seed=1).items()})
        out.append((float(met["loss"]), model.param_leaves()))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5)
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=5e-4, atol=5e-5)


def test_remat_policies_give_the_same_gradients():
    """``remat`` off, on (a pattern cycle recomputed) and with
    ``remat_policy="dots"`` (products kept): the same loss and
    gradients."""
    grads = []
    for kw in (dict(remat=False), dict(remat=True),
               dict(remat=True, remat_policy="dots")):
        cfg = dataclasses.replace(smoke_config("recurrentgemma-9b"),
                                  dtype="float32", **kw)
        model = LModel(cfg, device="cpu", dtype=torch.float32,
                       generator=torch.Generator().manual_seed(1))
        ts = model.param_leaves()
        for t in ts:
            t.requires_grad_(True)
        loss = model.loss_fn({k: torch.as_tensor(v)
                              for k, v in batch(cfg).items()})
        grads.append([loss] + list(torch.autograd.grad(loss, ts)))
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _dense_moe(cfg, p, x):
    """Every expert on every token, combined by the top-k weights (the
    JAX package's ``tests/test_moe.py::_dense_ref``)."""
    E, k = cfg.n_experts, cfg.moe_topk
    probs = torch.softmax(torch.einsum("gnd,de->gne", x, p["router"]), -1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    gate = torch.einsum("gnd,edf->gnef", x, p["w_gate"])
    up = torch.einsum("gnd,edf->gnef", x, p["w_up"])
    out = torch.einsum("gnef,efd->gned", torch.nn.functional.silu(gate) * up,
                       p["w_down"])
    cmb = torch.zeros((*x.shape[:2], E))
    for j in range(k):
        cmb = cmb + w[..., j:j + 1] * torch.nn.functional.one_hot(
            idx[..., j], E)
    return torch.einsum("gne,gned->gnd", cmb, out)


def test_moe_grads_match_dense_and_jax():
    """The gather dispatch's gradients (autograd of the port's index
    maps) equal the dense every-expert reference's and the JAX
    ``custom_vjp`` gathers' (``test_moe_grads_match_dense``)."""
    from repro.configs import smoke_config as jax_smoke_config
    from repro.models import param as rparam
    jcfg = dataclasses.replace(jax_smoke_config("grok-1-314b"),
                               dtype="float32", capacity_factor=8.0)
    cfg = dataclasses.replace(smoke_config("grok-1-314b"), dtype="float32",
                              capacity_factor=8.0)
    jp = rparam.materialize(RM.moe_specs(jcfg), jax.random.key(0),
                            dtype=jnp.float32)
    x = np.random.default_rng(1).normal(size=(3, 16, cfg.d_model)).astype(
        np.float32)

    def port_grads(fn):
        p = map_tree(lambda a: torch.tensor(np.asarray(a),
                                            requires_grad=True), jp)
        xt = torch.tensor(x, requires_grad=True)
        torch.sin(fn(p, xt)).sum().backward()
        return p, xt

    p1, x1 = port_grads(lambda p, xt: M.apply_moe(cfg, p, xt)[0])
    p2, x2 = port_grads(lambda p, xt: _dense_moe(cfg, p, xt))
    jg = jax.jit(jax.grad(
        lambda p, xx: jnp.sum(jnp.sin(RM.apply_moe(jcfg, p, xx)[0])),
        argnums=(0, 1)))(jp, jnp.asarray(x))
    for key in ("w_up", "w_gate", "w_down", "router"):
        torch.testing.assert_close(p1[key].grad, p2[key].grad, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(p1[key].grad.numpy(),
                                   np.asarray(jg[0][key]), rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    torch.testing.assert_close(x1.grad, x2.grad, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(x1.grad.numpy(), np.asarray(jg[1]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_decreases(arch):
    """Five steps on a repeated batch reduce the loss (the JAX package's
    ``test_smoke_loss_decreases``), in each arch's dtypes (bf16 weights,
    its optimizer and state dtype); dtypes and shapes are kept and the
    eval step gives the loss of the trained parameters."""
    cfg = smoke_config(arch)
    model = LModel(cfg, max_seq=64, device="cpu",
                   generator=torch.Generator().manual_seed(2))
    before = [(t.dtype, t.shape) for t in model.param_leaves()]
    ocfg = O.OptConfig(peak_lr=1e-2, warmup_steps=1, decay_steps=100,
                       algorithm=cfg.optimizer,
                       state_dtype=cfg.opt_state_dtype)
    st = O.init_state(ocfg, model.param_tree())
    step = make_train_step(model, ocfg)
    b = {k: torch.as_tensor(v) for k, v in batch(cfg, B=4, seed=3).items()}
    if cfg.enc_dec:
        b["enc_inputs"] = b["enc_inputs"].to(torch.bfloat16)
    losses = []
    for _ in range(5):
        st, m = step(st, b)
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    assert losses[-1] < losses[0], losses
    assert int(st["step"]) == 5
    assert [(t.dtype, t.shape) for t in model.param_leaves()] == before
    assert all(bool(torch.isfinite(t.float()).all())
               for t in model.param_leaves())
    assert np.isfinite(float(make_eval_step(model)(b)))
