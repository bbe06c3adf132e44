"""Port parity: the enc-dec path (whisper-large-v3) and learned
positions against the JAX package, at smoke size in float32.

Parameters are made once with ``jax.random`` and carried across by
``models.convert.load_jax_params``; inputs come from numpy seeds.
Logits, caches, prefill and every decode step agree within ``rtol=2e-3,
atol=3e-4`` (the JAX package's own ``test_decode_equiv`` bounds: the two
frameworks add in other orders); the query-chunked encoder attention is
exact against the unchunked one within 1e-5 (its
``test_q_chunked_encoder_attention_exact``).  The decode step's
attention, self and cross, goes through kernel 5's entry point, whose
CPU branch is the plain version; the kernel is held against it on the
card by ``chip_smoke.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.configs import smoke_config as jax_smoke_config
from repro.models import layers as RL
from repro.models import param as rparam
from repro.models.model import LModel as JaxLModel
from repro.serve.decode import BatchScheduler as JaxScheduler
from repro.serve.decode import Request as JaxRequest

import torch
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import param as tparam
from repro_torch.models import transformer as T
from repro_torch.models.model import LModel
from repro_torch.serve.decode import BatchScheduler, Request

from torch_threads import one_thread  # noqa: F401

RTOL, ATOL = 2e-3, 3e-4
WHISPER = "whisper-large-v3"


def _models(arch, max_seq=64, **change):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               **change)
    jm = JaxLModel(jcfg, max_seq=max_seq)
    params = rparam.materialize(jm.param_specs(), jax.random.key(0),
                                dtype=jnp.float32)
    tcfg = dataclasses.replace(smoke_config(arch), dtype="float32",
                               **change)
    model = LModel(tcfg, max_seq=max_seq, device="cpu", dtype=torch.float32)
    convert.load_jax_params(model, jax.tree.map(np.asarray, params))
    return jm, params, model


def _close(a, b, **kw):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **kw)


def _check_cache(jax_cache, port_cache):
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jax_cache))[0]
    got = dict(tparam.leaves(convert.cache_to_numpy(port_cache)))
    assert len(want) == len(got)
    for path, w in want:
        g = got[tuple(k.key for k in path)]
        assert g.shape == w.shape, path
        _close(g, w, rtol=RTOL, atol=ATOL, err_msg=str(path))


def _inputs(cfg, B, S, Se, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    enc = rng.normal(size=(B, Se, cfg.d_model)).astype(np.float32)
    return toks, enc


def test_whisper_specs_and_leaves_match_jax():
    """The tree (decoder with ``ln_x``/``xattn``, ``pos_emb``, the
    encoder's stack, norm and table) leaf for leaf, at smoke size and
    full width (1,535,956,480 parameters at max_seq 448, never
    allocated)."""
    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as RT
    from repro_torch.configs import get_config
    jm, params, model = _models(WHISPER)
    specs = T.model_specs(model.cfg, max_seq=64)
    assert tparam.count(specs) == rparam.count(jm.param_specs())
    assert tparam.nbytes(specs) == rparam.nbytes(jm.param_specs())
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(tparam.leaves(model.param_tree()))
    assert len(flat) == len(got)
    for path, a in flat:
        np.testing.assert_array_equal(
            got[tuple(k.key for k in path)].detach().numpy(), np.asarray(a))
    full = T.model_specs(get_config(WHISPER), max_seq=448)
    assert tparam.count(full) == rparam.count(RT.model_specs(
        jax_get_config(WHISPER), max_seq=448)) == 1_535_956_480
    assert [(b.kind, b.key, b.group) for b in model.enc_blocks] == \
        [("global", "pos0", g) for g in range(model.cfg.n_enc_layers)]


def test_whisper_matches_jax_and_the_full_forward():
    """The encoder, ``logits_seq`` with ``enc_inputs``, the cross caches,
    a chunked prefill and every decode step (kernel 5's plain version
    over the self and cross caches) against the JAX package and against
    the full forward (``test_decode_equiv``'s whisper case)."""
    jm, params, model = _models(WHISPER)
    B, S, PRE, Se = 2, 12, 8, 10
    toks, enc = _inputs(model.cfg, B, S, Se, 3)
    tt, te = torch.as_tensor(toks), torch.as_tensor(enc)
    jenc = jnp.asarray(enc)
    eo, ep = jm._encode(params, jenc)
    with torch.no_grad():
        to, tp = model._encode(te)
    _close(to, eo, rtol=RTOL, atol=ATOL)
    assert np.array_equal(tp.numpy(), np.asarray(ep))
    full = model.logits_seq(tt, te)
    _close(full, jm.logits_seq(params, jnp.asarray(toks), enc_inputs=jenc),
           rtol=RTOL, atol=ATOL)
    jc = jm.build_cross_caches(
        params, jm.init_cache(B, S, dtype=jnp.float32, cross_len=Se), jenc)
    pc = model.build_cross_caches(
        model.init_cache(B, S, dtype=torch.float32, cross_len=Se), te)
    _check_cache(jc, pc)
    jl, jc = jm.prefill(params, jnp.asarray(toks[:, :PRE]), jc, chunk=4)
    pl, pc = model.prefill(tt[:, :PRE], pc, chunk=4)
    _close(pl, jl, rtol=RTOL, atol=ATOL)
    _close(pl, full[:, PRE - 1], rtol=RTOL, atol=ATOL)
    _check_cache(jc, pc)
    for t in range(PRE, S):
        jl, jc = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]), jc)
        pl, pc = model.decode_step(tt[:, t:t + 1], pc)
        _close(pl, jl, rtol=RTOL, atol=ATOL, err_msg=f"step {t}")
        _close(pl, full[:, t], rtol=RTOL, atol=ATOL, err_msg=f"step {t}")
    _check_cache(jc, pc)
    assert pc["length"].tolist() == [S, S]


def test_cross_decode_is_the_unmasked_attention():
    """The cross-attention decode step (kernel 5's entry point with
    ``length`` the cross cache's capacity) against the JAX
    ``attention_decode(cross_cache=)`` (``_attn_core``, ``causal=False``,
    mask ``k_pos >= 0``), and the cache left untouched."""
    jm, params, model = _models(WHISPER)
    cfg = model.cfg
    rng = np.random.default_rng(4)
    B, Se = 3, 11
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    k, v = (rng.normal(size=(B, Se, cfg.n_kv_heads, cfg.head_dim))
            .astype(np.float32) for _ in range(2))
    pos = np.tile(np.arange(Se, dtype=np.int32), (B, 1))
    pos_t = np.full((B, 1), 5, np.int32)
    xp = params["blocks"]["pos0"]["xattn"]
    want, _ = RL.attention_decode(
        jm.cfg, jax.tree.map(lambda a: a[1], xp), jnp.asarray(x),
        jnp.asarray(pos_t), None,
        cross_cache={"k": jnp.asarray(k), "v": jnp.asarray(v),
                     "pos": jnp.asarray(pos)})
    cross = {"k": torch.as_tensor(k), "v": torch.as_tensor(v),
             "pos": torch.as_tensor(pos)}
    before = {n: t.clone() for n, t in cross.items()}
    with torch.no_grad():
        got = L.attention_decode(cfg, model.blocks[1]["xattn"],
                                 torch.as_tensor(x), torch.as_tensor(pos_t),
                                 None, cross_cache=cross)
    _close(got, want, rtol=1e-5, atol=1e-6)
    assert all(torch.equal(before[n], cross[n]) for n in cross)


def test_q_chunked_encoder_attention_exact():
    """``attn_q_chunk=4`` (query chunks in the encoder's bidirectional
    and the decoder's cross attention) equals the unchunked path within
    1e-5, and the JAX package's chunked path."""
    jm, params, m0 = _models(WHISPER)
    _, _, m1 = _models(WHISPER, attn_q_chunk=4)
    toks, enc = _inputs(m0.cfg, 2, 16, 16, 2)
    tt, te = torch.as_tensor(toks), torch.as_tensor(enc)
    l0, l1 = m0.logits_seq(tt, te), m1.logits_seq(tt, te)
    _close(l1, l0, rtol=1e-5, atol=1e-5)
    jm1 = JaxLModel(dataclasses.replace(jm.cfg, attn_q_chunk=4), max_seq=64)
    _close(l1, jm1.logits_seq(params, jnp.asarray(toks),
                              enc_inputs=jnp.asarray(enc)),
           rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pos_emb", ["learned", "none"])
def test_decoder_positions_match_jax(pos_emb):
    """qwen3-8b with a learned position table (``max_seq`` rows) and with
    no positions: logits, chunked prefill and decode steps against the
    JAX package."""
    jm, params, model = _models("qwen3-8b", max_seq=32, pos_emb=pos_emb)
    assert ("pos_emb" in params) == (pos_emb == "learned")
    B, S, PRE = 2, 12, 8
    toks = np.random.default_rng(5).integers(
        0, model.cfg.vocab_size, (B, S)).astype(np.int32)
    tt = torch.as_tensor(toks)
    _close(model.logits_seq(tt), jm.logits_seq(params, jnp.asarray(toks)),
           rtol=RTOL, atol=ATOL)
    jc = jm.init_cache(B, S, dtype=jnp.float32)
    pc = model.init_cache(B, S, dtype=torch.float32)
    jl, jc = jm.prefill(params, jnp.asarray(toks[:, :PRE]), jc, chunk=4)
    pl, pc = model.prefill(tt[:, :PRE], pc, chunk=4)
    _close(pl, jl, rtol=RTOL, atol=ATOL)
    for t in range(PRE, S):
        jl, jc = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]), jc)
        pl, pc = model.decode_step(tt[:, t:t + 1], pc)
        _close(pl, jl, rtol=RTOL, atol=ATOL, err_msg=f"step {t}")
    _check_cache(jc, pc)


def test_learned_positions_out_of_range_follow_the_reference():
    """The reference's semantics past ``max_seq`` rows, reproduced: a
    prefill chunk's start is clamped as ``dynamic_slice_in_dim`` clamps it
    (the same logits and caches as the JAX package); a decode step past
    the table gives NaN logits, as ``jnp.take`` does; more encoder frames
    than rows fail to broadcast; neither raises where the reference does
    not."""
    max_seq = 6
    jm, params, model = _models("qwen3-8b", max_seq=max_seq,
                                pos_emb="learned")
    toks = np.random.default_rng(6).integers(
        0, model.cfg.vocab_size, (2, 10)).astype(np.int32)
    tt = torch.as_tensor(toks)
    jc = jm.init_cache(2, 12, dtype=jnp.float32)
    pc = model.init_cache(2, 12, dtype=torch.float32)
    # 8 tokens in chunks of 4 through a 6-row table: the second chunk's
    # start 4 is clamped to 2
    jl, jc = jm.prefill(params, jnp.asarray(toks[:, :8]), jc, chunk=4)
    pl, pc = model.prefill(tt[:, :8], pc, chunk=4)
    _close(pl, jl, rtol=RTOL, atol=ATOL)
    _check_cache(jc, pc)
    jl, jc = jm.decode_step(params, jnp.asarray(toks[:, 8:9]), jc)
    pl, pc = model.decode_step(tt[:, 8:9], pc)
    assert np.isnan(np.asarray(jl)).all() and torch.isnan(pl).all()
    # a table row read from the end (jnp.take wraps a negative index)
    table = torch.arange(12.0).reshape(6, 2)
    got = L.learned_pos_take(table, torch.tensor([[-1], [5], [6]]))
    want = jnp.take(jnp.asarray(table.numpy()), jnp.asarray([[-1], [5], [6]]),
                    axis=0)
    _close(got, want, equal_nan=True)
    jw, wparams, whisper = _models(WHISPER, max_seq=max_seq)
    enc = np.zeros((1, max_seq + 1, whisper.cfg.d_model), np.float32)
    with pytest.raises(Exception):
        jw._encode(wparams, jnp.asarray(enc))
    with pytest.raises(RuntimeError):
        whisper.logits_seq(torch.zeros((1, 2), dtype=torch.int32),
                           torch.as_tensor(enc))


@dataclasses.dataclass(frozen=True)
class _JaxF32Cache(JaxLModel):
    """The JAX model with float32 caches, as the port's scheduler gets
    them here (``test_torch_lm_families_serve.py``'s)."""

    def init_cache(self, batch, capacity, dtype=jnp.float32, cross_len=0):
        return super().init_cache(batch, capacity, dtype=dtype,
                                  cross_len=cross_len)


def test_whisper_scheduler_matches_jax():
    """whisper through the slot scheduler, as the JAX scheduler serves it
    (no cross caches: a decoder that never sees the encoder), 2 slots and
    3 requests (a slot reused): the same token streams."""
    _, params, model = _models(WHISPER, max_seq=24)
    jm = _JaxF32Cache(dataclasses.replace(jax_smoke_config(WHISPER),
                                          dtype="float32"), max_seq=24)
    model.init_cache = functools.partial(LModel.init_cache, model,
                                         dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, 4) for _ in range(3)]
    js = JaxScheduler(jm, params, slots=2, capacity=24)
    ps = BatchScheduler(model, slots=2, capacity=24)
    assert "xattn" not in ps.cache["blocks"]["pos0"]
    for i, p in enumerate(prompts):
        js.submit(JaxRequest(i, p, 5))
        ps.submit(Request(i, p, 5))
    want = {r.rid: r.out for r in js.run()}
    got = {r.rid: r.out for r in ps.run()}
    assert got == want


def test_serve_main_serves_whisper(capsys):
    sched = tserve.main(["--arch", WHISPER, "--smoke", "--device", "cpu",
                         "--slots", "2", "--requests", "3", "--max-new",
                         "4"])
    assert len(sched.done) == 3
    assert all(len(r.out) == 4 for r in sched.done)
    assert sched.model.max_seq == 64
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out
