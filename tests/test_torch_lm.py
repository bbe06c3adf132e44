"""Port parity: the LM serving path (configs, LModel, kernel 5's plain
version, the slot scheduler and the driver) against the JAX package.

Inputs and parameters are made once with numpy or ``jax.random`` from a
seed and handed to both packages as numpy arrays.  Models run in float32
at smoke size; logits and caches must agree within ``rtol=2e-3,
atol=3e-4`` (the JAX package's own decode-equivalence tolerance: the
two frameworks add in other orders).  Kernel 5's plain version must
match the JAX oracle and the Pallas kernel (interpret mode) within
``rtol=1e-4, atol=1e-5`` in float32 (``tests/test_kernels.py``'s) and,
in bf16, within ``rtol=1e-2`` (each side rounds to bf16 once) plus
``1e-3`` of the output's largest magnitude.  The CUDA kernel is held
against the plain version on the card by ``chip_smoke.py``.
"""
import dataclasses

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import repro.core  # noqa: F401  (import order: core before kernels)
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.models import param as rparam
from repro.models.model import LModel as JaxLModel
from repro.serve.decode import BatchScheduler as JaxScheduler
from repro.serve.decode import Request as JaxRequest
from repro.serve.decode import slot_view as jax_slot_view

import torch
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.kernels import decode_gqa as tdg
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import param as tparam
from repro_torch.models import transformer as T
from repro_torch.models.model import LModel
from repro_torch.serve.decode import BatchScheduler, Request, slot_view
from torch_threads import one_thread  # noqa: F401

RTOL, ATOL = 2e-3, 3e-4


def _jax_model(arch):
    cfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    model = JaxLModel(cfg)
    params = rparam.materialize(model.param_specs(), jax.random.key(0),
                                dtype=jnp.float32)
    return model, params


def _port_model(arch, jax_params):
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    model = LModel(cfg, device="cpu", dtype=torch.float32)
    convert.load_jax_params(model, jax.tree.map(np.asarray, jax_params))
    return model


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **kw)


# -- kernel 5's plain version ------------------------------------------------


def _decode_inputs(B, S, K, G, h, dtype, seed):
    rng = np.random.default_rng(seed)
    q, kc, vc = (rng.normal(size=s).astype(np.float32)
                 for s in ((B, K, G, h), (B, S, K, h), (B, S, K, h)))
    length = rng.integers(1, S + 1, B).astype(np.int32)
    pos = np.where(np.arange(S)[None] < length[:, None],
                   np.arange(S)[None], -1).astype(np.int32)
    jx = [jnp.asarray(a, dtype) for a in (q, kc, vc)] + \
        [jnp.asarray(pos), jnp.asarray(length)]
    tt = [convert.to_tensor(np.asarray(a)) for a in jx]
    return jx, tt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,K,G,h,bs", [
    (2, 64, 4, 2, 16, 16), (3, 100, 2, 4, 32, 32),
    (1, 512, 8, 4, 128, 128), (2, 33, 1, 1, 8, 8)])
def test_decode_gqa_plain_matches_jax(B, S, K, G, h, bs, dtype):
    jx, tt = _decode_inputs(B, S, K, G, h, getattr(jnp, dtype), B * S)
    got = tops.decode_gqa(*tt)
    assert got.dtype == tt[0].dtype and tuple(got.shape) == (B, K, G, h)
    want = rref.decode_gqa_ref(*jx)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else dict(
        rtol=1e-2, atol=1e-3 * float(jnp.abs(want.astype(jnp.float32)).max()))
    _close(convert.to_numpy(got), want, **tol)
    _close(convert.to_numpy(got), rops.decode_gqa(*jx, block_s=bs), **tol)


def test_decode_gqa_plain_masks_nan_slots():
    """A NaN in a masked slot (past length or pos == -1) does not reach
    the output; a custom scale is honoured."""
    _, (q, kc, vc, pos, length) = _decode_inputs(2, 40, 2, 4, 16,
                                                  jnp.float32, 3)
    pos = pos.clone()
    pos[:, 0] = -1
    want = tops.decode_gqa(q, kc, vc, pos, length, scale=0.3)
    kc, vc = kc.clone(), vc.clone()
    kc[:, 0] = vc[:, 0] = float("nan")              # the hole
    kc[0, int(length[0]):] = vc[0, int(length[0]):] = float("nan")
    got = tops.decode_gqa(q, kc, vc, pos, length, scale=0.3)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())


def test_decode_gqa_wrapper_refuses_other_devices():
    """A tensor neither on the CPU nor on CUDA never reaches a plain
    version, but for ``meta`` (the dry run's trace), where the plain
    version gives only the result's shape and dtype and nothing runs."""
    _, tt = _decode_inputs(1, 8, 1, 1, 8, jnp.float32, 0)
    before = tdg.decode_gqa.launches
    out = tdg.decode_gqa(*(t.to("meta") for t in tt))
    assert out.device.type == "meta" and out.shape == tt[0].shape
    other = types.SimpleNamespace(shape=tt[0].shape,
                                  device=torch.device("xpu"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tdg.decode_gqa(other, *tt[1:])
    assert tdg.decode_gqa.launches == before


def _split_combine(q, kc, vc, pos, length, *, scale, tile, splits,
                   bf16_p):
    """Kernel 5's decomposition in plain PyTorch (float32): row b's
    ``[0, n)`` cut into ``splits`` equal tile-aligned shares; each share's
    ``(m, l, acc)`` over its valid slots (for bf16, ``p`` enters the
    product as the kernel's two bf16 terms, ``hi = bf16(p)`` and
    ``bf16(p - hi)``); the shares merged by ``e^{m_i - M}``, a share with
    ``m_i = -inf`` adding 0."""
    B, S, K, h = kc.shape
    G = q.shape[2]
    out = torch.zeros((B, K, G, h))
    inf = float("inf")
    for b in range(B):
        n = min(max(int(length[b]), 0), S)
        ntiles = -(-n // tile)
        per = -(-ntiles // splits)
        parts = []
        for sp in range(splits):
            ta = min(sp * per, ntiles)
            lo, hi = ta * tile, min((ta + per) * tile, n)
            valid = pos[b, lo:hi] >= 0
            v = vc[b, lo:hi].float().masked_fill(~valid[:, None, None], 0.0)
            sc = torch.einsum("kgh,skh->kgs", q[b].float(),
                              kc[b, lo:hi].float()) * scale
            sc = sc.masked_fill(~valid[None, None], -inf)
            m = sc.amax(-1) if hi > lo else torch.full((K, G), -inf)
            p = torch.where(m[..., None] > -inf,
                            torch.exp(sc - m[..., None]), 0.0)
            pv = p
            if bf16_p:
                hi = p.bfloat16().float()
                pv = hi + (p - hi).bfloat16().float()
            parts.append((m, p.sum(-1), torch.einsum("kgs,skh->kgh", pv, v)))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        L, A = torch.zeros((K, G)), torch.zeros((K, G, h))
        for m, l, acc in parts:
            w = torch.where(m > -inf, torch.exp(m - M), 0.0)
            L, A = L + w * l, A + w[..., None] * acc
        out[b] = A / L.clamp_min(1e-38)[..., None]
    return out


# (B, S, K, G, h, row lengths, masked front of row 0): shares past length,
# wholly masked shares, n < splits x tile, B·K = 1, two query-head groups
_SPLIT_CASES = [(2, 256, 2, 4, 16, (20, 256), 128),
                (1, 300, 1, 8, 32, (300,), 0),
                (2, 700, 1, 12, 8, (700, 90), 500),
                (3, 129, 2, 1, 24, (1, 129, 64), 0)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,K,G,h,lengths,front", _SPLIT_CASES)
def test_decode_gqa_split_combine_matches(B, S, K, G, h, lengths, front,
                                          dtype):
    """The kernel's split-and-combine, with the wrapper's split plan for a
    132-SM card, matches the plain version (NaN in every masked slot) and
    the JAX oracle (masked slots zero: it lets 0 * NaN through): float32
    within rtol 1e-4 atol 1e-5, bf16 within rtol 1e-2 + 1e-3 max|out|."""
    rng = np.random.default_rng(B * S + h)
    q, kc, vc = (rng.normal(size=sh).astype(np.float32)
                 for sh in ((B, K, G, h), (B, S, K, h), (B, S, K, h)))
    length = np.asarray(lengths, np.int32)
    slots = np.arange(S)[None]
    pos = np.where(slots < length[:, None], slots, -1)
    pos[rng.random((B, S)) < 0.05] = -1
    pos[:, 0] = 0                       # every row keeps a valid slot
    pos[0, 1:front] = -1
    pos = pos.astype(np.int32)
    valid = (slots < length[:, None]) & (pos >= 0)
    kc[~valid] = 0.0
    vc[~valid] = 0.0
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, kc, vc)] + \
        [jnp.asarray(pos), jnp.asarray(length)]
    oracle = np.asarray(rref.decode_gqa_ref(*jx), np.float32)
    kc[~valid] = np.nan
    vc[~valid] = np.nan
    tt = [convert.to_tensor(np.asarray(jnp.asarray(a, getattr(jnp, dtype))))
          for a in (q, kc, vc)] + [torch.as_tensor(pos),
                                   torch.as_tensor(length)]
    warps, splits = tdg.split_plan(B, S, K, G, h, tt[0].element_size(), 132)
    tile = tdg.WARP_SLOTS * warps
    assert splits > 1
    got = _split_combine(*tt, scale=h ** -0.5, tile=tile, splits=splits,
                         bf16_p=dtype == "bfloat16")
    assert bool(torch.isfinite(got).all())
    want = tops.decode_gqa(*tt).float()
    for ref in (want.numpy(), oracle):
        tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else dict(
            rtol=1e-2, atol=1e-3 * float(np.abs(ref).max()))
        _close(got, ref, **tol)


def test_split_plan_covers_the_card():
    """Splits from the shapes and the SM count alone, filling the blocks
    the SMs hold at once (two at bf16 h = 128) in one wave: the served
    shape takes 4, one long row 33 (4 warps: 64-slot tiles); a float32
    row of h = 256 halves the warps to fit its rings; the splits never
    exceed the capacity's tiles; more rows than blocks take one."""
    assert tdg.split_plan(8, 4096, 8, 4, 128, 2, 132) == (4, 4)
    assert tdg.split_plan(1, 32768, 8, 4, 128, 2, 132) == (4, 33)
    assert tdg.split_plan(1, 32768, 1, 8, 128, 2, 132) == (4, 264)
    assert tdg.split_plan(2, 2048, 1, 8, 256, 4, 132) == (2, 64)
    assert tdg.split_plan(4, 100, 8, 4, 64, 2, 132) == (4, 2)
    assert tdg.split_plan(64, 4096, 8, 4, 128, 2, 132) == (4, 1)


# -- configs and parameters --------------------------------------------------


def test_configs_match_jax():
    from repro.configs import registry as rreg
    from repro_torch.configs import registry as treg
    assert set(ARCHS) == set(rreg.ARCHS)
    for name in ARCHS:
        for fn in ("get_config", "smoke_config"):
            assert dataclasses.asdict(getattr(treg, fn)(name)) == \
                dataclasses.asdict(getattr(rreg, fn)(name)), (name, fn)


@pytest.mark.parametrize("arch", ["qwen3-8b", "chatglm3-6b"])
def test_load_jax_params_every_leaf(arch):
    jm, params = _jax_model(arch)
    model = _port_model(arch, params)
    specs = T.model_specs(model.cfg)
    assert tparam.count(specs) == rparam.count(jm.param_specs())
    assert tparam.nbytes(specs) == rparam.nbytes(jm.param_specs())
    assert sum(p.numel() for p in model.parameters()) == tparam.count(specs)
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert len(flat) == len(list(tparam.leaves(specs)))
    for path, a in flat.items():
        keys = [k.key for k in path]
        if keys[0] == "blocks":
            for g in range(a.shape[0]):
                blk = model.blocks[g]
                np.testing.assert_array_equal(
                    blk[keys[2]][keys[3]].numpy(), np.asarray(a)[g])
        else:
            np.testing.assert_array_equal(
                getattr(model, keys[0])[keys[1]].numpy(), np.asarray(a))


def test_full_width_specs_match_jax():
    """qwen3-8b at full width: the same count and bytes as the JAX
    package's specs (7.57 B parameters, 15.1 GB in bf16) and 147,456 cache
    bytes a token, never allocated."""
    from repro.configs import get_config as jax_get_config
    from repro.models import transformer as RT
    cfg = get_config("qwen3-8b")
    specs = T.model_specs(cfg)
    jspecs = RT.model_specs(jax_get_config("qwen3-8b"))
    assert tparam.count(specs) == rparam.count(jspecs)
    assert tparam.nbytes(specs) == rparam.nbytes(jspecs)
    assert 7.5e9 < tparam.count(specs) < 7.6e9
    cache = T.cache_specs(cfg, 1, 1)
    per_token = tparam.nbytes(cache) - 4 - 4 * cfg.n_layers   # length, pos
    assert per_token == 147_456


# -- the model against the JAX LModel ----------------------------------------


def _check_cache(jax_cache, port_cache):
    want = jax.tree.map(np.asarray, jax_cache)
    got = convert.cache_to_numpy(port_cache)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(tparam.leaves(got))
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        g = flat_g[tuple(k.key for k in path)]
        assert g.shape == w.shape, path
        _close(g, w, rtol=RTOL, atol=ATOL, err_msg=str(path))


@pytest.mark.parametrize("arch,cap", [("qwen3-8b", 16), ("qwen3-8b", 10),
                                      ("chatglm3-6b", 10)])
def test_model_matches_jax(arch, cap):
    """logits_seq, chunked prefill, four decode steps and the caches after
    each; capacity 10 < 12 tokens makes the ring wrap."""
    jm, params = _jax_model(arch)
    model = _port_model(arch, params)
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
    lo, _ = model.decode_step(tt[:, PRE:PRE + 1],
                              convert.cache_from_jax(
                                  convert.cache_to_numpy(pc)))
    _close(lc, lo, rtol=RTOL, atol=ATOL)
    for t in range(PRE, S):
        jl, jc = jm.decode_step(params, jnp.asarray(toks[:, t:t + 1]), jc)
        pl, pc = model.decode_step(tt[:, t:t + 1], pc)
        _close(pl, jl, rtol=RTOL, atol=ATOL, err_msg=f"step {t}")
        _check_cache(jc, pc)


def test_prefill_decode_matches_full_forward():
    """The port's own prefill + decode (through kernel 5's entry point)
    equals its full-sequence logits (the plain attention path)."""
    cfg = dataclasses.replace(smoke_config("qwen3-8b"), dtype="float32")
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


# -- serving -----------------------------------------------------------------


def test_scheduler_matches_jax():
    """3 slots, 5 requests, 6 new tokens (examples/serve_lm.py's shape):
    the same token streams as the JAX scheduler (host syncs are counted
    only on CUDA)."""
    jm, params = _jax_model("qwen3-8b")
    model = _port_model("qwen3-8b", params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, int(rng.integers(2, 8)))
               for _ in range(5)]
    js = JaxScheduler(jm, params, slots=3, capacity=64)
    ps = BatchScheduler(model, slots=3, capacity=64)
    for i, p in enumerate(prompts):
        js.submit(JaxRequest(i, p, 6))
        ps.submit(Request(i, p, 6))
    want = {r.rid: r.out for r in js.run()}
    got = {r.rid: r.out for r in ps.run()}
    assert got == want
    assert ps.decode_steps == len(ps.step_walls_s) > 0
    assert ps.step_syncs == []
    assert len(ps.prefill_walls_s) == 5
    # the slots' final caches, one slot at a time (bf16, from float32
    # k/v that differ in the last digits: one bf16 rounding step apart)
    for slot in range(3):
        want_c = jax.tree.map(np.asarray, jax_slot_view(js.cache, slot))
        got_c = dict(tparam.leaves(convert.cache_to_numpy(
            slot_view(ps.cache, slot))))
        for path, w in jax.tree_util.tree_flatten_with_path(want_c)[0]:
            g = got_c[tuple(k.key for k in path)]
            assert g.shape == w.shape
            _close(g, w, rtol=1e-2, atol=1e-2, err_msg=str(path))


def test_sync_count_reads_cuda_sync_warnings(monkeypatch):
    """The decode step's sync count: CUDA's sync debug mode is set to warn
    inside the block and restored after; its warnings are counted and
    swallowed, others pass through; the CPU counts nothing."""
    import warnings
    from repro_torch.serve import decode as sd
    modes = [3]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    counts = []
    with pytest.warns(RuntimeWarning, match="other") as passed:
        with sd._counting_syncs(torch.device("cuda"), counts):
            assert modes[-1] == "warn"
            for _ in range(2):
                warnings.warn(sd._SYNC_WARNING)
            warnings.warn("other", RuntimeWarning)
    assert counts == [2] and modes[-1] == 3
    assert [str(w.message) for w in passed] == ["other"]
    with pytest.warns(UserWarning, match="synchronizing"):
        with sd._counting_syncs(torch.device("cpu"), counts):
            warnings.warn(sd._SYNC_WARNING)
    assert counts == [2] and modes == [3, "warn", 3]


def test_serve_main_serves_every_request(capsys):
    sched = tserve.main(["--arch", "qwen3-8b", "--smoke", "--device", "cpu",
                         "--slots", "3", "--requests", "5", "--max-new",
                         "6"])
    assert len(sched.done) == 5
    assert all(len(r.out) == 6 for r in sched.done)
    assert "served 5 requests, 30 tokens" in capsys.readouterr().out


def test_model_needs_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LModel(smoke_config("qwen3-8b"))


@pytest.mark.parametrize("arch", [
    "qwen3-8b", "mistral-nemo-12b", "chatglm3-6b", "chameleon-34b",
    "gemma3-4b", "grok-1-314b", "moonshot-v1-16b-a3b", "falcon-mamba-7b",
    "recurrentgemma-9b", "whisper-large-v3"])
def test_served_configs_build(arch):
    model = LModel(smoke_config(arch), device="cpu")
    assert len(model.blocks) == model.cfg.n_layers
    assert model.embed["tok"].dtype == torch.bfloat16
