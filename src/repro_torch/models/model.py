"""Top-level per-arch model: full-sequence logits, prefill and decode.

Counterpart of ``repro.models.model.LModel`` as an ``nn.Module``: the
embedding and final norm are ``transformer.ParamTree``s and the layers an
``nn.ModuleList`` of :class:`transformer.Block`.  Parameters are drawn at
construction from an explicit ``torch.Generator`` (seed 0 when none is
given) on the model's device; ``device=None`` means the CUDA device and
raises without one.  Caches stay a dict of tensors with the JAX package's
keys and layout (``transformer.init_cache``); prefill and decode fill
them in place and return them.

The port serves every decoder-only arch with RoPE: the dense
``global``-attention stacks (qwen3-8b, mistral-nemo-12b, chatglm3-6b,
chameleon-34b), windowed ``local`` attention (gemma3-4b), MoE FFNs
(moonshot-v1-16b-a3b; grok-1-314b, with the attention soft-cap), Mamba
(falcon-mamba-7b) and RG-LRU with local attention and remainder layers
(recurrentgemma-9b).  An enc-dec config (whisper-large-v3) or one without
RoPE raises ``NotImplementedError`` naming ROADMAP item 14.  ``loss_fn``,
the encoder and the cross-attention caches are not ported.  The
``ps.constrain*`` sharding hints are dropped (one device).
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
    if cfg.enc_dec:
        why.append("enc-dec (item 14.4)")
    if cfg.pos_emb != "rope":
        why.append(f"pos_emb={cfg.pos_emb!r} (item 14.4)")
    if why:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(why)} {_LATER}")


def prefill_chunks(cfg: ArchConfig, S: int, chunk: int = 0, *,
                   rings=(), base: int = 0):
    """A prefill's chunks of an ``S``-token prompt, ``(offset, length)``,
    at most ``chunk`` tokens each (``S`` when 0), written after ``base``
    cached tokens into attention rings ``rings``, ``(kind, slots)`` pairs.

    The JAX package takes equal chunks, the largest divisor of ``S`` up to
    ``chunk``; a prime-length prompt past ``chunk`` then runs one token a
    chunk.  Where the chunks fall leaves the function unchanged only when
    no ring drops a key that a later query of the prompt attends to: every
    ``global`` ring holds ``base + S`` tokens, and every ``local`` ring
    holds them or its whole window.  A ring that wraps otherwise (concat
    before write lets a query see ``slots`` keys plus its chunk's earlier
    ones), or a MoE stack (it routes each chunk's rows as its groups, so
    its capacity and drops depend on the chunk), keeps the divisor rule.
    Any other stack takes chunks of ``chunk`` and a shorter last one."""
    chunk = min(chunk or S, S)
    end = base + S
    fixed = not cfg.n_experts and all(
        end <= n or (kind == "local" and cfg.window and n >= cfg.window)
        for kind, n in rings)
    if not fixed:
        while S % chunk:
            chunk -= 1
    return [(o, min(chunk, S - o)) for o in range(0, S, chunk)]


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
        self.embed = T.ParamTree(top["embed"])
        self.final_norm = T.ParamTree(top["final_norm"])
        # one layer at a time, in execution order (group by group, then
        # the remainder), so that no stacked leaf is drawn whole
        self.blocks = nn.ModuleList(
            T.Block(materialize(T.block_specs(cfg, kind), generator,
                                device=device, dtype=dtype), kind, key, g)
            for kind, key, g in T.layer_slots(cfg))

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
        """Chunked prefill (chunks from :func:`prefill_chunks`). Returns
        (last_token_logits, cache).

        ``base = max(length)``, where a continued prefill starts, is one
        device→host read per call."""
        cfg = self.cfg
        S = tokens.shape[1]
        base = int(cache["length"].max())
        last = None
        rings = [(blk.kind, T.layer_cache(cache, blk)["attn"]["k"].shape[1])
                 for blk in self.blocks if blk.kind in ("global", "local")]
        for local, n in prefill_chunks(cfg, S, chunk, rings=rings,
                                       base=base):
            start = base + local          # global position (RoPE, ring slots)
            x, pos = self._embed_tokens(tokens[:, local:local + n],
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
