"""Port parity: the mixers and MoE of the decoder-only LM families, and
the attention parts they bring, function by function against the JAX
package.

``repro_torch.models.ssm`` (the doubling scan against the JAX
``associative_scan``, the causal conv, Mamba-1 and RG-LRU in sequence and
decode form), ``repro_torch.models.moe`` (the capacity, the routing maps,
forward, drops and single-token decode), the soft-cap in kernel 5's plain
version against the JAX ``_attn_core``, and ``_attn_local_chunked``
against the windowed ``_attn_core``.  Inputs and parameters are made
with numpy or ``jax.random`` from a seed and handed to both packages as
numpy arrays, in float32; single functions agree within ``rtol=1e-4,
atol=1e-5`` (the scan within ``rtol=1e-5``).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.configs import smoke_config as jax_smoke_config
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models import param as rparam
from repro.models import ssm as RS

import torch
from repro_torch.configs import smoke_config
from repro_torch.kernels.ref import decode_gqa_ref
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.param import map_tree
from torch_threads import one_thread  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5


def _cfgs(arch, **kw):
    return (dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                                **kw),
            dataclasses.replace(smoke_config(arch), dtype="float32", **kw))


def _params(specs, seed=0):
    """JAX float32 parameters and the same numbers as port tensors."""
    p = rparam.materialize(specs, jax.random.key(seed), dtype=jnp.float32)
    return p, map_tree(convert.to_tensor, jax.tree.map(np.asarray, p))


def _close(a, b, rtol=RTOL, atol=ATOL, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol, **kw)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# -- the scan and the conv ---------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 37, 5), (2, 16, 3, 4), (1, 1, 6),
                                   (3, 64, 8)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_linear_recurrence_matches_associative_scan(shape, with_h0):
    rng = np.random.default_rng(len(shape) * 10 + shape[1])
    a = rng.uniform(0.5, 1.0, shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    h0 = rng.normal(size=(shape[0],) + shape[2:]).astype(np.float32) \
        if with_h0 else None
    want = RS.linear_recurrence(jnp.asarray(a), jnp.asarray(b),
                                None if h0 is None else jnp.asarray(h0))
    got = S.linear_recurrence(_t(a), _t(b), None if h0 is None else _t(h0))
    _close(got, want, rtol=1e-5, atol=1e-6)
    # and the sequential recurrence it stands for
    h = np.zeros_like(b[:, 0]) if h0 is None else h0
    for t in range(shape[1]):
        h = a[:, t] * h + b[:, t]
        _close(got[:, t], h, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_seq_and_step(with_state):
    rng = np.random.default_rng(3)
    jp, tp = _params(RS.causal_conv_specs(4, 12), seed=1)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state \
        else None
    jy, js = RS.causal_conv_seq(jp, jnp.asarray(x),
                                None if st is None else jnp.asarray(st))
    ty, ts = S.causal_conv_seq(tp, _t(x), None if st is None else _t(st))
    _close(ty, jy)
    _close(ts, js)
    xt = rng.normal(size=(2, 1, 12)).astype(np.float32)
    jy, js = RS.causal_conv_step(jp, jnp.asarray(xt), js)
    ty, ts = S.causal_conv_step(tp, _t(xt), ts)
    _close(ty, jy)
    _close(ts, js)


# -- Mamba-1 and RG-LRU ------------------------------------------------------


@pytest.mark.parametrize("kind", ["mamba", "rglru"])
def test_mixer_seq_and_decode(kind):
    """Sequence form from a zero state, then from a carried state (a
    continued prefill), then three decode steps; outputs and both state
    tensors each time."""
    arch = "falcon-mamba-7b" if kind == "mamba" else "recurrentgemma-9b"
    jcfg, tcfg = _cfgs(arch)
    specs = getattr(RS, f"{kind}_specs")(jcfg)
    jp, tp = _params(specs, seed=2)
    jseq, tseq = getattr(RS, f"{kind}_seq"), getattr(S, f"{kind}_seq")
    jdec, tdec = getattr(RS, f"{kind}_decode"), getattr(S, f"{kind}_decode")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 11, jcfg.d_model)).astype(np.float32)
    jy, jst = jseq(jcfg, jp, jnp.asarray(x[:, :6]))
    ty, tst = tseq(tcfg, tp, _t(x[:, :6]))
    _close(ty, jy)
    for a, b in zip(tst, jst):
        _close(a, b)
    jy, jst = jseq(jcfg, jp, jnp.asarray(x[:, 6:8]), conv_state=jst[0],
                   h0=jst[1])
    ty, tst = tseq(tcfg, tp, _t(x[:, 6:8]), conv_state=tst[0], h0=tst[1])
    _close(ty, jy)
    for t in range(8, 11):
        jy, jst = jdec(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jst)
        ty, tst = tdec(tcfg, tp, _t(x[:, t:t + 1]), tst)
        _close(ty, jy, err_msg=f"{kind} decode {t}")
        for a, b in zip(tst, jst):
            _close(a, b)
    init = getattr(S, f"{kind}_state_init")(tcfg, 3)
    want = getattr(RS, f"{kind}_state_init")(jcfg, 3)
    assert [tuple(a.shape) for a in init] == [a.shape for a in want]
    assert [str(a.dtype) for a in init] == ["torch.bfloat16",
                                            "torch.float32"]


def test_mixer_decode_equals_its_sequence_form():
    """The decode step's one fused update continues the scan: a sequence
    prefilled token by token equals it whole."""
    jcfg, tcfg = _cfgs("falcon-mamba-7b")
    _, tp = _params(RS.mamba_specs(jcfg), seed=5)
    x = _t(np.random.default_rng(6).normal(
        size=(1, 7, tcfg.d_model)).astype(np.float32))
    whole, (cs, h) = S.mamba_seq(tcfg, tp, x)
    state = S.mamba_state_init(tcfg, 1, torch.float32)
    for t in range(7):
        y, state = S.mamba_decode(tcfg, tp, x[:, t:t + 1], state)
        _close(y[:, 0], whole[:, t])
    _close(state[1], h)
    _close(state[0], cs)


# -- MoE ---------------------------------------------------------------------


@pytest.mark.parametrize("N,cf", [(1, 1.25), (16, 1.25), (200, 1.25),
                                  (1536, 1.25), (2048, 64 / 6), (7, 1e-6)])
def test_capacity_matches_jax(N, cf):
    for arch in ("moonshot-v1-16b-a3b", "grok-1-314b"):
        from repro.configs import get_config as jax_get_config
        from repro_torch.configs import get_config
        j = dataclasses.replace(jax_get_config(arch), capacity_factor=cf)
        t = dataclasses.replace(get_config(arch), capacity_factor=cf)
        assert M._capacity(t, N) == RM._capacity(j, N)


@pytest.mark.parametrize("G,N,k,E,C", [(3, 16, 2, 4, 16), (2, 9, 6, 64, 1),
                                       (2, 40, 2, 8, 6)])
def test_routing_maps_match_jax(G, N, k, E, C):
    rng = np.random.default_rng(G + N + k + E)
    idx = np.stack([np.stack([rng.choice(E, k, replace=False)
                              for _ in range(N)]) for _ in range(G)])
    want = RM._routing_maps(jnp.asarray(idx, jnp.int32), E, C)
    got = M._routing_maps(torch.as_tensor(idx), E, C)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch,cf", [("grok-1-314b", 8.0),
                                     ("moonshot-v1-16b-a3b", 4.0),
                                     ("grok-1-314b", 0.5),
                                     ("moonshot-v1-16b-a3b", 0.3)])
def test_apply_moe_matches_jax(arch, cf):
    """Forward and the load-balance loss, dropless and with a capacity
    factor that drops tokens (the same tokens in both packages)."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    jp, tp = _params(RM.moe_specs(jcfg))
    x = np.random.default_rng(1).normal(
        size=(3, 16, jcfg.d_model)).astype(np.float32)
    jy, jaux = RM.apply_moe(jcfg, jp, jnp.asarray(x))
    ty, taux = M.apply_moe_auto(tcfg, tp, _t(x))
    _close(ty, jy)
    _close(taux, jaux)
    C = M._capacity(tcfg, 16)
    if cf < 1:
        full, _ = M.apply_moe(dataclasses.replace(tcfg, capacity_factor=8.0),
                              tp, _t(x))
        assert C < 16 * tcfg.moe_topk // tcfg.n_experts + 1 < 16
        assert not torch.allclose(ty, full)


def test_moe_decode_single_token():
    """Single-token groups (a decode step: one token a batch row; C = 1
    at moonshot's full config) equal the JAX package's, and a row's answer
    is its own."""
    from repro_torch.configs import get_config
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b")
    jp, tp = _params(RM.moe_specs(jcfg))
    x = np.random.default_rng(2).normal(
        size=(4, 1, jcfg.d_model)).astype(np.float32)
    jy, _ = RM.apply_moe(jcfg, jp, jnp.asarray(x))
    ty, _ = M.apply_moe(tcfg, tp, _t(x))
    assert M._capacity(get_config("moonshot-v1-16b-a3b"), 1) == 1
    _close(ty, jy)
    alone, _ = M.apply_moe(tcfg, tp, _t(x[1:2]))
    _close(alone, ty[1:2])


# -- attention: the soft-cap and the local window -----------------------------


@pytest.mark.parametrize("softcap", [0.0, 30.0, 0.5])
def test_decode_gqa_softcap_matches_attn_core(softcap):
    """Kernel 5's plain version with ``softcap`` against the JAX
    ``_attn_core`` on one decode query (the function the port's decode
    step replaces), on caches with empty slots."""
    jcfg, _ = _cfgs("grok-1-314b", attn_softcap=softcap)
    B, S_, K, G, h = 3, 20, jcfg.n_kv_heads, jcfg.q_per_kv, jcfg.head_dim
    rng = np.random.default_rng(7)
    q = (4 * rng.normal(size=(B, 1, K * G, h))).astype(np.float32)
    kc = (4 * rng.normal(size=(B, S_, K, h))).astype(np.float32)
    vc = rng.normal(size=(B, S_, K, h)).astype(np.float32)
    length = np.array([20, 7, 1], np.int32)
    pos = np.where(np.arange(S_)[None] < length[:, None], np.arange(S_)[None],
                   -1).astype(np.int32)
    pos[0, 3] = -1
    q_pos = (length - 1)[:, None]
    want = RL._attn_core(jcfg, jnp.asarray(q),
                         RL._kv_expand(jcfg, jnp.asarray(kc)),
                         RL._kv_expand(jcfg, jnp.asarray(vc)),
                         jnp.asarray(q_pos), jnp.asarray(pos), causal=True,
                         window=0)
    got = decode_gqa_ref(_t(q).reshape(B, K, G, h), _t(kc), _t(vc), _t(pos),
                         _t(length), softcap=softcap)
    _close(got.reshape(B, 1, K * G, h), want)
    if softcap:
        plain = decode_gqa_ref(_t(q).reshape(B, K, G, h), _t(kc), _t(vc),
                               _t(pos), _t(length))
        assert not torch.allclose(plain, got, atol=1e-3)


@pytest.mark.parametrize("arch", ["gemma3-4b", "grok-1-314b"])
def test_attn_core_matches_jax(arch):
    """The port's ``_attn_core``: window and soft-cap terms."""
    jcfg, tcfg = _cfgs(arch)
    rng = np.random.default_rng(8)
    B, Sq, Sk, H, h = 2, 6, 14, jcfg.n_heads, jcfg.head_dim
    q = (3 * rng.normal(size=(B, Sq, H, h))).astype(np.float32)
    k = (3 * rng.normal(size=(B, Sk, H, h))).astype(np.float32)
    v = rng.normal(size=(B, Sk, H, h)).astype(np.float32)
    k_pos = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    k_pos[1, :4] = -1
    q_pos = np.tile(np.arange(8, 8 + Sq, dtype=np.int32), (B, 1))
    for window in (0, jcfg.window or 5):
        want = RL._attn_core(jcfg, *map(jnp.asarray, (q, k, v, q_pos,
                                                      k_pos)),
                             causal=True, window=window)
        got = L._attn_core(tcfg, *map(_t, (q, k, v, q_pos, k_pos)),
                           window=window)
        _close(got, want)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_attn_local_chunked_matches_unchunked_window(softcap):
    """Block-local windowed attention ≡ the windowed ``_attn_core``, and
    ≡ the JAX ``_attn_local_chunked`` (the JAX package's
    ``test_local_attn_chunked_exact``, function by function)."""
    jcfg, tcfg = _cfgs("gemma3-4b", attn_softcap=softcap,
                       local_attn_chunked=True)
    rng = np.random.default_rng(9)
    B, S_, H, h = 2, 32, jcfg.n_heads, jcfg.head_dim
    q, k, v = (rng.normal(size=(B, S_, H, h)).astype(np.float32)
               for _ in range(3))
    pos = np.tile(np.arange(S_, dtype=np.int32), (B, 1))
    chunked = L._attn_local_chunked(tcfg, *map(_t, (q, k, v, pos)))
    full = L._attn_core(tcfg, *map(_t, (q, k, v, pos, pos)),
                        window=tcfg.window)
    _close(chunked, full)
    _close(chunked, RL._attn_local_chunked(jcfg, *map(jnp.asarray,
                                                       (q, k, v, pos))))


def test_moe_auto_takes_the_gather_path_on_one_device():
    """``moe_impl="shardmap"`` (the JAX package's hillclimb profile) needs
    a mesh; on one device ``apply_moe_auto`` is ``apply_moe``, as the JAX
    package's is without a mesh."""
    jcfg, tcfg = _cfgs("moonshot-v1-16b-a3b", moe_impl="shardmap")
    jp, tp = _params(RM.moe_specs(jcfg))
    x = np.random.default_rng(3).normal(
        size=(2, 8, jcfg.d_model)).astype(np.float32)
    jy, _ = RM.apply_moe_auto(jcfg, jp, jnp.asarray(x))
    ty, _ = M.apply_moe_auto(tcfg, tp, _t(x))
    _close(ty, jy)
    assert torch.equal(ty, M.apply_moe(tcfg, tp, _t(x))[0])
