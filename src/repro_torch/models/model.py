"""Top-level per-arch model: full-sequence logits, prefill and decode.

Counterpart of ``repro.models.model.LModel`` as an ``nn.Module``: the
embedding and final norm are ``nn.ParameterDict``s and the layers an
``nn.ModuleList`` of :class:`transformer.Block`.  Parameters are drawn at
construction from an explicit ``torch.Generator`` (seed 0 when none is
given) on the model's device; ``device=None`` means the CUDA device and
raises without one.  Caches stay a dict of tensors with the JAX package's
keys and layout (``transformer.init_cache``); prefill and decode fill
them in place and return them.

This slice serves stacks of ``global`` attention layers with a dense MLP
and RoPE (qwen3-8b, mistral-nemo-12b, chatglm3-6b, chameleon-34b); any
other config raises ``NotImplementedError`` naming ROADMAP item 14.
``loss_fn``, the encoder and the cross-attention caches are not ported.
The ``ps.constrain*`` sharding hints are dropped (one device).
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..core.comm import resolve_device
from . import layers as L
from . import transformer as T
from .param import materialize

_LATER = "waits for ROADMAP item 14"


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not serve."""
    why = []
    if cfg.n_experts:
        why.append("MoE (soft-cap and MoE, item 14.2)")
    if cfg.attn_pattern != ("global",):
        why.append(f"layer pattern {cfg.attn_pattern} (local: item 14.1; "
                   "SSM and RG-LRU: item 14.3)")
    if cfg.enc_dec:
        why.append("enc-dec (item 14.4)")
    if cfg.attn_softcap:
        why.append("attention soft-cap (item 14.2)")
    if cfg.pos_emb != "rope":
        why.append(f"pos_emb={cfg.pos_emb!r} (item 14.4)")
    if why:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(why)} {_LATER}")


class LModel(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        """``dtype`` casts every parameter (``None``: each spec's own,
        bf16 weights and float32 norms, as the JAX package's ``init``)."""
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        specs = T.model_specs(cfg)
        top = materialize({"embed": specs["embed"],
                           "final_norm": specs["final_norm"]}, generator,
                          device=device, dtype=dtype)
        self.embed = T.params(top["embed"])
        self.final_norm = T.params(top["final_norm"])
        self.blocks = nn.ModuleList(
            T.Block(materialize(T.block_specs(cfg), generator,
                                device=device, dtype=dtype))
            for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    # -- shared -------------------------------------------------------------
    def _embed_tokens(self, tokens, start: int = 0):
        x = L.embed(self.cfg, self.embed, tokens)
        S = tokens.shape[1]
        pos = start + torch.arange(S, dtype=torch.int32, device=tokens.device)
        return x, pos.expand(tokens.shape)

    @torch.no_grad()
    def logits_seq(self, tokens):
        """Full-sequence logits (testing / eval); the plain attention path,
        which never reaches kernel 5."""
        x, pos = self._embed_tokens(tokens)
        x = T.run_stack_seq(self.cfg, self.blocks, x, pos)
        x = L.apply_norm(self.cfg, self.final_norm, x)
        return L.unembed(self.cfg, self.embed, x)

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch, capacity, dtype=torch.bfloat16):
        return T.init_cache(self.cfg, batch, capacity, dtype,
                            device=self.device)

    @torch.no_grad()
    def prefill(self, tokens, cache, *, chunk: int = 0):
        """Chunked prefill. Returns (last_token_logits, cache).

        ``base = max(length)``, where a continued prefill starts, is one
        device→host read per call."""
        cfg = self.cfg
        S = tokens.shape[1]
        chunk = chunk or S
        while S % chunk:
            chunk -= 1
        base = int(cache["length"].max())
        last = None
        for i in range(S // chunk):
            local = i * chunk             # offset into `tokens`
            start = base + local          # global position (RoPE, ring slots)
            x, pos = self._embed_tokens(tokens[:, local:local + chunk],
                                        start=start)
            x, cache = T.run_stack_append(cfg, self.blocks, cache, x, pos,
                                          start)
            last = x[:, -1]
        cache = dict(cache, length=cache["length"] + S)
        h = L.apply_norm(cfg, self.final_norm, last[:, None])
        return L.unembed(cfg, self.embed, h)[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens_t, cache):
        """tokens_t (B,1). Returns (logits (B,V), cache)."""
        cfg = self.cfg
        pos_t = cache["length"][:, None]
        x = L.embed(cfg, self.embed, tokens_t)
        x, cache = T.run_stack_decode(cfg, self.blocks, cache, x, pos_t)
        x = L.apply_norm(cfg, self.final_norm, x)
        logits = L.unembed(cfg, self.embed, x)
        cache = dict(cache, length=cache["length"] + 1)
        return logits[:, 0], cache
