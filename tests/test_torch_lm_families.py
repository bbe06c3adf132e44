"""Port parity: the decoder-only LM families at smoke size against the
JAX ``LModel`` and ``BatchScheduler``.

gemma3-4b (local:global 5:1, window 8 at smoke size), grok-1-314b (MoE
with the attention soft-cap), moonshot-v1-16b-a3b (fine-grained MoE),
falcon-mamba-7b (Mamba) and recurrentgemma-9b (RG-LRU + local attention,
with a remainder layer).  Weights come from ``jax.random`` and cross over
through ``models.convert.load_jax_params``; inputs from numpy seeds.
Models run in float32; logits and caches agree within ``rtol=2e-3,
atol=3e-4`` (the JAX package's own decode-equivalence tolerance, as in
``test_torch_lm.py``).  The scheduler tests admit more requests than
there are slots, so a slot is reused by a later request
(``test_torch_lm_families_serve.py``).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.configs import smoke_config as jax_smoke_config
from repro.models import param as rparam
from repro.models import transformer as RT
from repro.models.model import LModel as JaxLModel

import torch
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import convert
from repro_torch.models import param as tparam
from repro_torch.models import transformer as T
from repro_torch.models.model import LModel
from torch_threads import one_thread  # noqa: F401

RTOL, ATOL = 2e-3, 3e-4
FAMILIES = ["gemma3-4b", "grok-1-314b", "moonshot-v1-16b-a3b",
            "falcon-mamba-7b", "recurrentgemma-9b"]


def _models(arch, **kw):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32", **kw)
    jm = JaxLModel(jcfg)
    params = rparam.materialize(jm.param_specs(), jax.random.key(0),
                                dtype=jnp.float32)
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32", **kw)
    model = LModel(cfg, device="cpu", dtype=torch.float32)
    convert.load_jax_params(model, jax.tree.map(np.asarray, params))
    return jm, params, model


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **kw)


def _path(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _check_cache(jax_cache, port_cache, **tol):
    tol = tol or dict(rtol=RTOL, atol=ATOL)
    flat_w = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jax_cache))[0]
    flat_g = dict(tparam.leaves(convert.cache_to_numpy(port_cache)))
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        g = flat_g[_path(path)]
        assert g.shape == w.shape, path
        _close(g, w, err_msg=str(path), **tol)


# -- specs, parameters, caches ------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_specs_and_cache_match_jax(arch):
    """At full width: the JAX package's parameter count and bytes, and the
    cache tree (a local layer's ring of min(window, capacity) slots, the
    mixers' state tuples, ``rem``) leaf for leaf, never allocated."""
    from repro.configs import get_config as jax_get_config
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    specs, jspecs = T.model_specs(cfg), RT.model_specs(jcfg)
    assert tparam.count(specs) == rparam.count(jspecs)
    assert tparam.nbytes(specs) == rparam.nbytes(jspecs)
    got = {p: (a.shape, str(a.dtype).replace("torch.", ""))
           for p, a in tparam.leaves(T.cache_specs(cfg, 4, 2048))}
    want = {_path(p): (a.shape, str(jnp.dtype(a.dtype)))
            for p, a in jax.tree_util.tree_flatten_with_path(
                RT.cache_specs(jcfg, 4, 2048),
                is_leaf=lambda x: isinstance(x, rparam.Annotated))[0]}
    assert got == want


@pytest.mark.parametrize("arch", FAMILIES)
def test_load_jax_params_every_leaf(arch):
    """Every JAX leaf lands in exactly one port parameter: block (g, j)
    holds index g of ``blocks/pos{j}``, remainder r ``rem/rem{r}``."""
    jm, params, model = _models(arch)
    cfg = model.cfg
    assert sum(p.numel() for p in model.parameters()) == \
        rparam.count(jm.param_specs())
    assert [(b.kind, b.key, b.group) for b in model.blocks] == \
        T.layer_slots(cfg)
    assert len(model.blocks) == cfg.n_layers
    for path, a in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = _path(path)
        if keys[0] not in ("blocks", "rem"):
            continue
        for blk in model.blocks:
            if blk.key != keys[1]:
                continue
            t = blk
            for k in keys[2:]:
                t = t[k]
            want = np.asarray(a)[blk.group] if keys[0] == "blocks" \
                else np.asarray(a)
            np.testing.assert_array_equal(t.numpy(), want)


def test_load_jax_params_refuses_a_missing_leaf():
    jm, params, model = _models("recurrentgemma-9b")
    tree = jax.tree.map(np.asarray, params)
    del tree["rem"]["rem0"]["mixer"]["lambda"]
    with pytest.raises(KeyError):
        convert.load_jax_params(model, tree)
    tree = jax.tree.map(np.asarray, params)
    tree["rem"]["rem0"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="no port parameter"):
        convert.load_jax_params(model, tree)


# -- the model against the JAX LModel ----------------------------------------


@pytest.mark.parametrize("arch,cap", [(a, 16) for a in FAMILIES]
                         + [("gemma3-4b", 10)])
def test_model_matches_jax(arch, cap):
    """logits_seq, chunked prefill, four decode steps and the caches after
    each; gemma3's local rings (8 slots) wrap at capacity 16, its global
    ring too at capacity 10."""
    jm, params, model = _models(arch)
    B, S, PRE = 2, 12, 8
    toks = np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (B, S)).astype(np.int32)
    tt = torch.as_tensor(toks)
    _close(model.logits_seq(tt), jm.logits_seq(params, jnp.asarray(toks)),
           rtol=RTOL, atol=ATOL)
    jc = jm.init_cache(B, cap, dtype=jnp.float32)
    pc = model.init_cache(B, cap, dtype=torch.float32)
    _check_cache(jc, pc)
    jl, jc = jm.prefill(params, jnp.asarray(toks[:, :PRE]), jc, chunk=4)
    pl, pc = model.prefill(tt[:, :PRE], pc, chunk=4)
    _close(pl, jl, rtol=RTOL, atol=ATOL)
    _check_cache(jc, pc)
    # a decode step from the JAX cache carried across equals one from the
    # port's own
    carried = convert.cache_from_jax(jax.tree.map(np.asarray, jc))
    _check_cache(jc, carried)
    lc, _ = model.decode_step(tt[:, PRE:PRE + 1], carried)
    lo, _ = model.decode_step(tt[:, PRE:PRE + 1], convert.cache_from_jax(
        convert.cache_to_numpy(pc)))
    _close(lc, lo, rtol=RTOL, atol=ATOL)
    for t in range(PRE, S):
        jl, jc = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]), jc)
        pl, pc = model.decode_step(tt[:, t:t + 1], pc)
        _close(pl, jl, rtol=RTOL, atol=ATOL, err_msg=f"step {t}")
        _check_cache(jc, pc)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_matches_full_forward(arch):
    """The port's own prefill + decode equals its full-sequence logits
    (the JAX package's ``test_prefill_decode_matches_forward``); the
    global rings hold the whole sequence, the local ones wrap under their
    window."""
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    model = LModel(cfg, device="cpu", dtype=torch.float32,
                   generator=torch.Generator().manual_seed(3))
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 14)))
    full = model.logits_seq(toks)
    cache = model.init_cache(2, 14, dtype=torch.float32)
    lg, cache = model.prefill(toks[:, :6], cache, chunk=3)
    _close(lg, full[:, 5], rtol=RTOL, atol=ATOL)
    for t in range(6, 14):
        lg, cache = model.decode_step(toks[:, t:t + 1], cache)
        _close(lg, full[:, t], rtol=RTOL, atol=ATOL, err_msg=f"step {t}")
    assert cache["length"].tolist() == [14, 14]


def test_prefill_chunks_rule():
    """A stack whose rings keep every key a query needs, and no MoE,
    takes chunks of the chunk and a shorter last one; a MoE stack, or a
    ring that wraps short of its window, keeps the JAX package's equal
    chunks (the largest divisor of the prompt up to the chunk)."""
    from repro_torch.models.model import prefill_chunks
    dense, moe = smoke_config("gemma3-4b"), smoke_config("grok-1-314b")
    fits = [("local", 8), ("global", 16)]
    assert prefill_chunks(dense, 13, 8, rings=fits) == [(0, 8), (8, 5)]
    assert prefill_chunks(dense, 16, 8, rings=fits) == [(0, 8), (8, 8)]
    assert prefill_chunks(dense, 5, 0, rings=fits) == [(0, 5)]
    assert prefill_chunks(moe, 13, 8, rings=fits) == \
        [(i, 1) for i in range(13)]
    assert prefill_chunks(moe, 12, 8, rings=fits) == [(0, 6), (6, 6)]
    assert prefill_chunks(dense, 1447, 1024,
                          rings=[("local", 1024), ("global", 2048)]) == \
        [(0, 1024), (1024, 423)]
    # the global ring wraps: 13 tokens after 0 or 4 into 16 slots
    assert prefill_chunks(dense, 13, 8, rings=fits, base=4) == \
        [(i, 1) for i in range(13)]
    assert prefill_chunks(dense, 13, 8, rings=[("global", 10)]) == \
        [(i, 1) for i in range(13)]
    # a local ring short of its window wraps; one of its window does not
    assert prefill_chunks(dense, 13, 8, rings=[("local", 6)]) == \
        [(i, 1) for i in range(13)]
    assert prefill_chunks(dense, 13, 8, rings=[("local", 8)]) == \
        [(0, 8), (8, 5)]


@pytest.mark.parametrize("arch,capacity", [("qwen3-8b", 10),
                                           ("gemma3-4b", 10),
                                           ("recurrentgemma-9b", 6)])
def test_prompt_past_a_ring_matches_jax(arch, capacity):
    """A 13-token prompt at chunk 4 into rings shorter than the prompt (a
    global ring of 10 slots, or a local ring of 6 short of its window of
    8): where the chunks fall changes the function, so the port takes the
    JAX package's chunks (13 of 1 token).  Logits and caches agree, and a
    second prefill past the ring continues as the JAX package's does."""
    jm, params, model = _models(arch)
    toks = np.random.default_rng(7).integers(
        0, model.cfg.vocab_size, (2, 18)).astype(np.int32)
    jc = jm.init_cache(2, capacity, dtype=jnp.float32)
    pc = model.init_cache(2, capacity, dtype=torch.float32)
    for a, b in ((0, 13), (13, 18)):
        jl, jc = jm.prefill(params, jnp.asarray(toks[:, a:b]), jc, chunk=4)
        pl, pc = model.prefill(torch.as_tensor(toks[:, a:b]), pc, chunk=4)
        _close(pl, jl, rtol=RTOL, atol=ATOL, err_msg=f"tokens {a}:{b}")
        _check_cache(jc, pc)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prime_prompt_prefill_matches_jax(arch):
    """A 13-token prompt at chunk 8 into rings that hold it: the JAX
    package runs 13 chunks of 1 token; the port's non-MoE stacks run 8 +
    5 (the same function), its MoE stacks the JAX package's chunks.
    Logits and caches agree."""
    jm, params, model = _models(arch)
    toks = np.random.default_rng(6).integers(
        0, model.cfg.vocab_size, (2, 13)).astype(np.int32)
    jl, jc = jm.prefill(params, jnp.asarray(toks),
                        jm.init_cache(2, 16, dtype=jnp.float32), chunk=8)
    pl, pc = model.prefill(torch.as_tensor(toks),
                           model.init_cache(2, 16, dtype=torch.float32),
                           chunk=8)
    _close(pl, jl, rtol=RTOL, atol=ATOL)
    _check_cache(jc, pc)


def test_local_attention_ring_wrap():
    """Chunked prefill past gemma3's window equals the full forward (the
    local rings wrap 4×), as the JAX package's test of the same name;
    and the JAX package's own prefill agrees."""
    jm, params, model = _models("gemma3-4b")
    toks = np.random.default_rng(4).integers(
        0, model.cfg.vocab_size, (1, 32)).astype(np.int32)
    full = model.logits_seq(torch.as_tensor(toks))
    lg, _ = model.prefill(torch.as_tensor(toks),
                          model.init_cache(1, 32, dtype=torch.float32),
                          chunk=8)
    _close(lg, full[:, -1], rtol=RTOL, atol=ATOL)
    jl, _ = jm.prefill(params, jnp.asarray(toks),
                       jm.init_cache(1, 32, dtype=jnp.float32), chunk=8)
    _close(lg, jl, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ["gemma3-4b", "recurrentgemma-9b",
                                  "falcon-mamba-7b"])
def test_prefill_continuation(arch):
    """prefill(a) then prefill(b) == prefill(a‖b): the ring offset and
    the carried SSM states."""
    _, _, model = _models(arch)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, model.cfg.vocab_size, (2, 16)))
    once, _ = model.prefill(toks, model.init_cache(
        2, 16, dtype=torch.float32), chunk=8)
    _, c = model.prefill(toks[:, :8], model.init_cache(
        2, 16, dtype=torch.float32), chunk=4)
    cont, _ = model.prefill(toks[:, 8:], c, chunk=4)
    _close(cont, once, rtol=RTOL, atol=ATOL)


def test_local_attn_chunked_model_exact():
    """``local_attn_chunked`` (block-local windows) ≡ the masked full
    attention through the whole model (the JAX package's
    ``test_local_attn_chunked_exact``)."""
    cfg = dataclasses.replace(smoke_config("gemma3-4b"), dtype="float32")
    m0 = LModel(cfg, device="cpu", dtype=torch.float32)
    m1 = LModel(dataclasses.replace(cfg, local_attn_chunked=True),
                device="cpu", dtype=torch.float32)
    m1.load_state_dict(m0.state_dict())
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)))
    _close(m0.logits_seq(toks), m1.logits_seq(toks), rtol=1e-4, atol=1e-4)
