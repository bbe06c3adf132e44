"""Transformer building blocks: attention (self, cross, bidirectional),
MLPs, norms, RoPE, learned positions and the embedding.

Counterpart of ``repro.models.layers``: causal self-attention, both
``global`` and windowed ``local`` (with ``_attn_local_chunked``), the
attention soft-cap, bidirectional (whisper's encoder) and cross-attention
with the query-chunked path under ``cfg.attn_q_chunk``, learned position
tables, dense MLPs, norms, RoPE and the embedding.  Functions take their
parameters as a mapping of tensors with the JAX package's keys, so the
shapes and layouts are the JAX package's: q ``(B, S, H, h)``, k/v ``(B,
S, K, h)``, caches ``(B, capacity, K, h)``.  The projections, the MLP and
``_attn_core``'s products are plain matrix products, as the JAX package
leaves them to XLA; only the decode step's attention, self and cross, is
a kernel (``kernels.ops.decode_gqa``, kernel 5).

Products of two dtypes compute in the promoted one, as ``jnp.einsum``
does (``_mm``): whisper's float32 frame embeddings through bf16 weights
give a float32 encoder, and the decoder's residual turns float32 at its
first cross-attention, in both packages.  The ``ps.constrain*`` sharding
hints have no single-device meaning and are dropped.  Caches are updated
in place (the ring writes), where the JAX package returns new arrays: a
decode step at full width would otherwise copy the whole cache every
layer.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels import ops
from .param import param

NEG_INF = -2.0e38  # large-negative fill that survives bf16


def _promoted(a: torch.Tensor, b: torch.Tensor):
    """``a`` and ``b`` in their promoted dtype: a product of two dtypes
    computes in it, as ``jnp.einsum`` and ``jnp.matmul`` compute it."""
    if a.dtype == b.dtype:
        return a, b
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _mm(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *_promoted(a, b))


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(*_promoted(a, b))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_specs(cfg: ArchConfig, d: int | None = None):
    d = d or cfg.d_model
    p = {"scale": param((d,), ("embed",), init="ones", dtype=torch.float32)}
    if cfg.norm == "layernorm":
        p["bias"] = param((d,), ("embed",), init="zeros", dtype=torch.float32)
    return p


def _rms(xf: torch.Tensor) -> torch.Tensor:
    return xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)


def apply_norm(cfg: ArchConfig, p, x):
    """RMS or layer norm, in float32 inside, cast back to ``x``'s dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:
        y = _rms(xf) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (full / partial — chatglm's 2d RoPE ≡ rotary over half the head dim)
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
         pct: float = 1.0) -> torch.Tensor:
    """x: (..., S, n, h); positions: broadcastable to (..., S)."""
    h = x.shape[-1]
    rot = int(h * pct) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None, None].float() * freq      # (...,S,1,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half].float(), xr[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([out.to(x.dtype), xp], -1)


def learned_pos_specs(cfg: ArchConfig, max_len: int):
    return param((max_len, cfg.d_model), ("seq", "embed"), scale=0.02)


def learned_pos_take(table: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, pos, axis=0)`` with its default ``fill`` mode:
    rows of ``table`` at ``pos``, a negative index counted from the end,
    and NaN rows where an index lies outside the table (the decode step's
    learned positions past ``max_seq``).  No host read."""
    n = table.shape[0]
    idx = torch.where(pos < 0, pos + n, pos)
    ok = (idx >= 0) & (idx < n)
    rows = table[idx.clamp(0, n - 1).long()]
    return torch.where(ok[..., None], rows,
                       torch.full((), float("nan"), dtype=table.dtype,
                                  device=table.device))


def learned_pos_slice(table: torch.Tensor, start: int, S: int):
    """``jax.lax.dynamic_slice_in_dim(table, start, S, 0)``: ``S`` rows
    from ``start``, the start clamped into ``[0, len - S]`` as XLA clamps
    it (a prefill past ``max_seq`` reads the last ``S`` rows).  More
    rows than the table holds raise, as there."""
    n = table.shape[0]
    if S > n:
        raise ValueError(f"a slice of {S} rows from a table of {n}")
    start = min(max(int(start), 0), n - S)
    return table[start:start + S]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def attention_specs(cfg: ArchConfig, *, cross: bool = False):
    """Self- or cross-attention projections (the same leaves)."""
    D, H, K, h = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": param((D, H, h), ("embed", "heads", "head_dim")),
        "wk": param((D, K, h), ("embed", "kv_heads", "head_dim")),
        "wv": param((D, K, h), ("embed", "kv_heads", "head_dim")),
        "wo": param((H, h, D), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        p["q_norm"] = param((h,), ("head_dim",), init="ones",
                            dtype=torch.float32)
        p["k_norm"] = param((h,), ("head_dim",), init="ones",
                            dtype=torch.float32)
    return p


def _qk_normalize(p, q, k):
    def rms(x, scale):
        return (_rms(x.float()) * scale).to(x.dtype)
    return rms(q, p["q_norm"]), rms(k, p["k_norm"])


def _kv_expand(cfg: ArchConfig, k: torch.Tensor) -> torch.Tensor:
    """(B,S,K,h) → (B,S,H,h): head n reads kv head n // G."""
    if cfg.n_kv_heads == cfg.n_heads:
        return k
    kv_map = torch.arange(cfg.n_heads, device=k.device) // cfg.q_per_kv
    return k.index_select(2, kv_map)


def _softcap(cfg: ArchConfig, s: torch.Tensor) -> torch.Tensor:
    """grok's logit soft-cap ``tanh(s / c) · c`` (none when ``c`` is 0)."""
    c = cfg.attn_softcap
    return torch.tanh(s / c) * c if c else s


def _attn_core(cfg: ArchConfig, q, k, v, q_pos, k_pos, *,
               causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,Sq,H,h); k,v (B,Sk,H,h); *_pos int32 (B,Sq)/(B,Sk); k_pos<0
    ⇒ empty.  ``causal`` keeps the keys with ``q_pos - k_pos >= 0``, and
    then a nonzero ``window`` those with ``q_pos - k_pos < window`` (a
    ``local`` layer); bidirectional and cross-attention mask empty keys
    only.  Scores in the inputs' promoted dtype (soft-capped there), the
    masked softmax in float32, ``p`` cast back to q's dtype before the PV
    product."""
    scale = cfg.head_dim ** -0.5
    s = _softcap(cfg, _mm("bqnh,bknh->bnqk", q, k) * scale)
    mask = (k_pos >= 0)[:, None, None, :]
    if causal:
        rel = q_pos[:, None, :, None] - k_pos[:, None, None, :]
        mask = mask & (rel >= 0)
        if window:
            mask = mask & (rel < window)
    s = torch.where(mask, s.float(), NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return _mm("bnqk,bknh->bqnh", p, v)


def _attn_local_chunked(cfg: ArchConfig, q, k, v, positions) -> torch.Tensor:
    """Block-local sliding-window attention, exact for window == chunk:
    query chunk c attends [chunk c−1 ‖ chunk c] under the ``0 <= rel <
    window`` mask, so the scores shrink from (S, S) to (S, 2W)."""
    B, S, H, h = q.shape
    W = cfg.window
    nc = S // W
    qc = q.reshape(B, nc, W, H, h)
    kc = k.reshape(B, nc, W, H, h)
    vc = v.reshape(B, nc, W, H, h)
    pc = positions.reshape(B, nc, W)
    k_prev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], 1)
    v_prev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], 1)
    p_prev = torch.cat([torch.full_like(pc[:, :1], -1), pc[:, :-1]], 1)
    kk = torch.cat([k_prev, kc], 2)                 # (B,nc,2W,H,h)
    vv = torch.cat([v_prev, vc], 2)
    pp = torch.cat([p_prev, pc], 2)                 # (B,nc,2W)
    s = torch.einsum("bcqnh,bcknh->bcnqk", qc, kk) * (cfg.head_dim ** -0.5)
    s = _softcap(cfg, s)
    rel = pc[:, :, None, :, None] - pp[:, :, None, None, :]
    mask = (pp >= 0)[:, :, None, None, :] & (rel >= 0) & (rel < W)
    s = torch.where(mask, s.float(), NEG_INF)
    a = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bcnqk,bcknh->bcqnh", a, vv)
    return o.reshape(B, S, H, h)


def _window(cfg: ArchConfig, kind: str) -> int:
    return cfg.window if kind == "local" else 0


def _project(cfg: ArchConfig, p, x, positions):
    """q, k, v of ``x`` (B,S,D) with qk-norm and RoPE at ``positions``."""
    return _project_kv(cfg, p, x, x, positions, positions)


def _project_kv(cfg: ArchConfig, p, x, kv_in, positions, k_pos, *,
                rope_k: bool = True):
    """q of ``x`` and k, v of ``kv_in``, with qk-norm, and RoPE at
    ``positions`` / ``k_pos`` (none on cross-attention: ``rope_k`` false
    skips RoPE on both, as the JAX package's ``attention_seq`` does)."""
    q = _mm("bsd,dnh->bsnh", x, p["wq"])
    k = _mm("bsd,dkh->bskh", kv_in, p["wk"])
    v = _mm("bsd,dkh->bskh", kv_in, p["wv"])
    if cfg.qk_norm:
        q, k = _qk_normalize(p, q, k)
    if cfg.pos_emb == "rope" and rope_k:
        q = rope(q, positions, theta=cfg.rope_theta, pct=cfg.rotary_pct)
        k = rope(k, k_pos, theta=cfg.rope_theta, pct=cfg.rotary_pct)
    return q, k, v


def attention_seq(cfg: ArchConfig, p, x, positions, *, kind: str = "global",
                  causal: bool = True, kv_x: torch.Tensor | None = None,
                  kv_positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence attention (``logits_seq``, the loss, the encoder and
    cross-attention over ``kv_x``): causal self-attention unless
    ``causal`` is false or ``kv_x`` is given.  A ``local`` layer masks
    keys outside its window, block-locally when ``cfg.local_attn_chunked``
    and the sequence is whole windows past one.  Bidirectional and cross
    attention take query chunks of ``cfg.attn_q_chunk`` when the sequence
    is whole chunks past one (each chunk sees every key: the function is
    the unchunked one).  It never reaches kernel 5."""
    kv_in = x if kv_x is None else kv_x
    k_pos = positions if kv_positions is None else kv_positions
    q, k, v = _project_kv(cfg, p, x, kv_in, positions, k_pos,
                          rope_k=kv_x is None)
    k, v = _kv_expand(cfg, k), _kv_expand(cfg, v)
    window = _window(cfg, kind)
    is_causal = causal and kv_x is None
    S, chunk = x.shape[1], cfg.attn_q_chunk
    if (window and cfg.local_attn_chunked and is_causal
            and S % window == 0 and S > window):
        o = _attn_local_chunked(cfg, q, k, v, positions)
    elif not is_causal and chunk and S % chunk == 0 and S > chunk:
        o = torch.cat([_attn_core(cfg, q[:, i:i + chunk], k, v,
                                  positions[:, i:i + chunk], k_pos,
                                  causal=False)
                       for i in range(0, S, chunk)], 1)
    else:
        o = _attn_core(cfg, q, k, v, positions, k_pos, causal=is_causal,
                       window=window)
    return _mm("bqnh,nhd->bqd", o, p["wo"])


# -- cached (serving) path ---------------------------------------------------


def attn_cache_specs(cfg: ArchConfig, batch: int, capacity: int,
                     dtype=torch.bfloat16):
    K, h = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": param((batch, capacity, K, h),
                   ("batch", "cache_seq", "cache_kv", "head_dim"),
                   dtype=dtype, init="zeros"),
        "v": param((batch, capacity, K, h),
                   ("batch", "cache_seq", "cache_kv", "head_dim"),
                   dtype=dtype, init="zeros"),
        "pos": param((batch, capacity), ("batch", "cache_seq"),
                     dtype=torch.int32, init="zeros", scale=-1.0),
    }


def init_attn_cache(cfg, batch, capacity, dtype=torch.bfloat16, *,
                    device=None):
    K, h = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, capacity, K, h), dtype=dtype, device=device),
        "v": torch.zeros((batch, capacity, K, h), dtype=dtype, device=device),
        "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                          device=device),
    }


def attention_append(cfg: ArchConfig, p, x, positions, cache, *,
                     kind: str = "global", start: int = 0):
    """Prefill a chunk: attend to [pre-chunk cache ‖ in-chunk k/v], then
    ring-write the chunk into ``cache`` in place and return the output.
    Concat-before-write keeps the early queries of a chunk that wraps the
    ring buffer (a ``local`` layer's ring holds ``min(window, capacity)``
    slots) from losing history a ring write of in-chunk duplicates would
    clobber; slots never written have ``pos == -1``, and stale ones lie
    outside a local layer's window: the mask excludes both.  ``start``
    is the chunk's first position, a host int."""
    S = x.shape[1]
    cap = cache["k"].shape[1]
    q, k, v = _project(cfg, p, x, positions)
    k_all = torch.cat([cache["k"].to(q.dtype), k], dim=1)
    v_all = torch.cat([cache["v"].to(q.dtype), v], dim=1)
    pos_all = torch.cat([cache["pos"], positions.to(torch.int32)], 1)
    o = _attn_core(cfg, q, _kv_expand(cfg, k_all), _kv_expand(cfg, v_all),
                   positions, pos_all, window=_window(cfg, kind))
    y = _mm("bqnh,nhd->bqd", o, p["wo"])
    # ring-write the chunk; keep only the last `cap` entries when the
    # chunk wraps, so that every slot is written once
    keep = min(S, cap)
    slots = (start + torch.arange(S - keep, S, device=x.device)) % cap
    cache["k"][:, slots] = k[:, -keep:].to(cache["k"].dtype)
    cache["v"][:, slots] = v[:, -keep:].to(cache["v"].dtype)
    cache["pos"][:, slots] = positions[:, -keep:].to(torch.int32)
    return y


def _cross_q(cfg: ArchConfig, p, x):
    """Cross-attention's queries: q of ``x``, q-norm only, no RoPE."""
    q = _mm("bsd,dnh->bsnh", x, p["wq"])
    if cfg.qk_norm:
        q = (_rms(q.float()) * p["q_norm"]).to(q.dtype)
    return q


def attention_cross(cfg: ArchConfig, p, x, positions, cross_cache):
    """Cross-attention of a prefill chunk ``x`` (B,S,D) over a cross cache
    (``build_cross_caches``'s encoder k/v): the JAX package's
    ``attention_decode(cross_cache=)`` on several queries, through
    ``_attn_core(causal=False)`` as plain products (XLA there, not a
    kernel)."""
    q = _cross_q(cfg, p, x)
    k = _kv_expand(cfg, cross_cache["k"].to(q.dtype))
    v = _kv_expand(cfg, cross_cache["v"].to(q.dtype))
    o = _attn_core(cfg, q, k, v, positions, cross_cache["pos"],
                   causal=False)
    return _mm("bqnh,nhd->bqd", o, p["wo"])


def attention_decode(cfg: ArchConfig, p, x_t, pos_t, cache, *,
                     kind: str = "global", cross_cache: dict | None = None):
    """One-token decode. x_t (B,1,D); pos_t (B,1) int32 current position.

    The token's k/v are ring-written into ``cache`` in place first (slot
    ``pos_t % cap``), then the attention runs through kernel 5
    (``ops.decode_gqa``) on the unexpanded caches: ``q`` as
    ``(B, K, G, h)`` (head ``n`` is kv head ``n // G``, what
    ``_kv_expand`` gathers), ``pos`` the ring-written positions and
    ``length = min(pos_t + 1, cap)``.  That is the function the JAX
    package computes with ``_attn_core``'s causal mask ``k_pos >= 0 &
    pos_t - k_pos >= 0``: after the write every cached slot holds a
    position ``<= pos_t`` (positions grow by one a step and the ring keeps
    the latest ``cap``), so the causal term is true wherever
    ``k_pos >= 0``; and the slots ``>= min(pos_t + 1, cap)`` are exactly
    those never written, whose ``pos`` is ``-1``.  The kernel's mask
    ``slot < length & pos >= 0`` therefore selects the same slots.

    A ``local`` layer adds ``pos_t - k_pos < window`` to that mask.  Its
    ring holds ``cap = min(window, capacity)`` slots
    (``transformer.init_cache``, the JAX package's ``_block_cache_init``),
    and after the write the ring holds the latest ``cap`` positions, so
    every valid slot has ``pos_t - k_pos <= cap - 1 < window``: the window
    term is true wherever the kernel's mask is, and kernel 5 needs no
    window term.  ``length`` comes from this layer's own capacity (gemma3's
    global and local layers have different ones).  A soft-capped config
    passes ``attn_softcap`` to the kernel, which caps the scores before
    its mask and online softmax as ``_attn_core`` does.  Returns the
    output; the cache is written in place.

    With ``cross_cache`` (the encoder's k/v, ``build_cross_caches``) this
    is the decode step's cross-attention, and ``cache`` is not touched:
    kernel 5 over the cross cache with ``length`` its capacity.  The JAX
    package's mask there is ``_attn_core``'s with ``causal=False``,
    ``k_pos >= 0`` alone; every slot lies below the capacity, so the
    kernel's ``slot < length & pos >= 0`` selects the same slots.  No
    ring write: a cross cache is written once, by ``build_cross_caches``
    (a cache never built holds ``pos = -1``: no valid slot, where the
    kernel gives zeros, as the reference's uniform softmax over zero
    values does, and the CPU's plain version NaN)."""
    B = x_t.shape[0]
    K, G, h = cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim
    if cross_cache is not None:
        q = _cross_q(cfg, p, x_t)
        cap = cross_cache["k"].shape[1]
        length = torch.full((B,), cap, dtype=torch.int32, device=x_t.device)
        o = ops.decode_gqa(q.reshape(B, K, G, h),
                           cross_cache["k"].to(q.dtype),
                           cross_cache["v"].to(q.dtype), cross_cache["pos"],
                           length, softcap=cfg.attn_softcap)
        return _mm("bqnh,nhd->bqd", o.reshape(B, 1, K * G, h), p["wo"])
    cap = cache["k"].shape[1]
    q, k, v = _project(cfg, p, x_t, pos_t)
    slot = (pos_t[:, 0] % cap).long()                  # (B,) ring slot
    bidx = torch.arange(B, device=x_t.device)
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][bidx, slot] = pos_t[:, 0].to(torch.int32)
    length = torch.clamp(pos_t[:, 0] + 1, max=cap).to(torch.int32)
    o = ops.decode_gqa(q.reshape(B, K, G, h), cache["k"].to(q.dtype),
                       cache["v"].to(q.dtype), cache["pos"], length,
                       softcap=cfg.attn_softcap)
    return _mm("bqnh,nhd->bqd", o.reshape(B, 1, K * G, h), p["wo"])


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU/GeGLU or plain 2-matrix)
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ArchConfig):
    D, Fd = cfg.d_model, cfg.d_ff
    p = {
        "w_up": param((D, Fd), ("embed", "ffn")),
        "w_down": param((Fd, D), ("ffn", "embed")),
    }
    if cfg.mlp_gated:
        p["w_gate"] = param((D, Fd), ("embed", "ffn"))
    return p


def _act(cfg: ArchConfig, x):
    # jax.nn.gelu's default is the tanh approximation
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def apply_mlp(cfg: ArchConfig, p, x):
    u = _matmul(x, p["w_up"])
    if cfg.mlp_gated:
        u = _act(cfg, _matmul(x, p["w_gate"])) * u
    else:
        u = _act(cfg, u)
    return _matmul(u, p["w_down"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_specs(cfg: ArchConfig):
    p = {"tok": param((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                      init="embed")}
    if not cfg.tie_embeddings:
        p["unembed"] = param((cfg.d_model, cfg.vocab_size),
                             ("embed", "vocab"))
    return p


def embed(cfg: ArchConfig, p, tokens):
    return p["tok"][tokens]


def unembed(cfg: ArchConfig, p, x):
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    return _matmul(x, w)
