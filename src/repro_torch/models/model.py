"""Top-level per-arch model: the loss, full-sequence logits, prefill and
decode.

Counterpart of ``repro.models.model.LModel`` as an ``nn.Module``: its
parameters are one ``transformer.ParamTree`` holding the JAX package's
tree (``params``; ``param_tree()`` gives it as a dict), and the layers
``transformer.Block`` views of it in execution order (``blocks``; the
encoder's ``enc_blocks``).  Parameters are drawn at construction from an
explicit ``torch.Generator`` (seed 0 when none is given) on the model's
device; ``device=None`` means the CUDA device and raises without one.
On ``device="meta"`` the model draws nothing and allocates nothing (its
leaves are empty ``meta`` tensors): the dry run traces its steps there
(``launch/cells.py``).  ``param_specs``, ``abstract_params`` and
``cache_specs`` give the annotated and abstract trees of the JAX
``LModel``.
Caches stay a dict of tensors with the JAX package's keys and layout
(``transformer.init_cache``); prefill, decode and ``build_cross_caches``
fill them in place and return them.

Every arch of the registry is served and trained: the dense
``global``-attention stacks (qwen3-8b, mistral-nemo-12b, chatglm3-6b,
chameleon-34b), windowed ``local`` attention (gemma3-4b), MoE FFNs
(moonshot-v1-16b-a3b; grok-1-314b, with the attention soft-cap), Mamba
(falcon-mamba-7b), RG-LRU with local attention and remainder layers
(recurrentgemma-9b), and the enc-dec whisper-large-v3 with learned
positions (``max_seq`` rows in the decoder's and in the encoder's table,
as in the JAX package: encoding 1,500 frames needs ``max_seq >= 1500``).
The serving entry points run under ``torch.no_grad``; ``loss_fn`` runs
under autograd.  The ``ps.constrain*`` sharding hints are dropped (one
device).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.comm import resolve_device
from . import layers as L
from . import transformer as T
from .param import abstract, leaves, materialize


def prefill_chunks(cfg: ArchConfig, S: int, chunk: int = 0, *,
                   rings=(), base: int = 0, max_seq: int | None = None):
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
    its capacity and drops depend on the chunk), keeps the divisor rule;
    so do learned positions past their table's ``max_seq`` rows (each
    chunk's start is clamped on its own).  Any other stack takes chunks
    of ``chunk`` and a shorter last one."""
    chunk = min(chunk or S, S)
    end = base + S
    fixed = not cfg.n_experts and all(
        end <= n or (kind == "local" and cfg.window and n >= cfg.window)
        for kind, n in rings) and (cfg.pos_emb != "learned"
                                   or max_seq is None or end <= max_seq)
    if not fixed:
        while S % chunk:
            chunk -= 1
    return [(o, min(chunk, S - o)) for o in range(0, S, chunk)]


class LModel(nn.Module):
    def __init__(self, cfg: ArchConfig, *, max_seq: int = 0, device=None,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        """``max_seq``: the learned position tables' rows (whisper; at
        least 1, as the JAX package's).  ``dtype`` casts every parameter
        (``None``: each spec's own, bf16 weights and float32 norms, as the
        JAX package's ``init``)."""
        super().__init__()
        self.cfg = cfg
        self.max_seq = max_seq
        device = resolve_device(device)
        if generator is None and device.type != "meta":
            generator = torch.Generator(device=device).manual_seed(0)
        self.params = T.ParamTree(materialize(
            T.model_specs(cfg, max_seq=max_seq), generator, device=device,
            dtype=dtype))
        self.blocks = T.stack_blocks(cfg, self.params)
        self.enc_blocks = T.stack_blocks(
            cfg, self.params["encoder"]["stack"], cfg.n_enc_layers,
            ("global",)) if cfg.enc_dec else []

    # -- specs ----------------------------------------------------------------
    def param_specs(self) -> dict:
        """The parameters' annotated tree (``param.Annotated`` leaves)."""
        return T.model_specs(self.cfg, max_seq=self.max_seq)

    def abstract_params(self, mesh, rules, *, fsdp: bool = True) -> dict:
        """The parameters as ``param.AbstractLeaf``s with resolved
        shardings on ``mesh``."""
        return abstract(self.param_specs(), mesh, rules, fsdp=fsdp)

    def cache_specs(self, batch, capacity, dtype=torch.bfloat16,
                    cross_len: int = 0) -> dict:
        """The cache's annotated tree (``init_cache``'s layout)."""
        return T.cache_specs(self.cfg, batch, capacity, dtype,
                             cross_len=cross_len)

    @property
    def embed(self) -> T.ParamTree:
        return self.params["embed"]

    @property
    def final_norm(self) -> T.ParamTree:
        return self.params["final_norm"]

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    def param_tree(self) -> dict:
        """The parameters as the JAX package's tree (a nested dict of this
        model's own tensors: writes to it are writes to the model)."""
        return self.params.tree()

    def param_leaves(self) -> list[torch.Tensor]:
        """The parameters in the JAX tree's leaf order."""
        return [t for _, t in leaves(self.param_tree())]

    # -- shared -------------------------------------------------------------
    def _encode(self, enc_inputs):
        """The encoder over precomputed frame embeddings ``(B, Se, D)``
        (the audio frontend is the reference's stub): learned positions
        ``[:Se]`` (more frames than ``max_seq`` rows fail to broadcast,
        as in the JAX package), bidirectional ``global`` layers, the
        final norm.  Returns (x, positions)."""
        cfg = self.cfg
        x = enc_inputs
        Se = x.shape[1]
        pos = torch.arange(Se, dtype=torch.int32,
                           device=x.device).expand(x.shape[:2])
        enc = self.params["encoder"]
        if cfg.pos_emb == "learned":
            x = x + enc["pos_emb"][:Se].to(x.dtype)
        x, _ = T.run_stack_seq(cfg, self.enc_blocks, x, pos, causal=False)
        return L.apply_norm(cfg, enc["final_norm"], x), pos

    def _embed_tokens(self, tokens, start: int = 0):
        cfg = self.cfg
        x = L.embed(cfg, self.embed, tokens)
        S = tokens.shape[1]
        pos = start + torch.arange(S, dtype=torch.int32, device=tokens.device)
        if cfg.pos_emb == "learned":
            x = x + L.learned_pos_slice(self.params["pos_emb"], start,
                                        S).to(x.dtype)
        return x, pos.expand(tokens.shape)

    def _hidden(self, tokens, enc_inputs=None):
        """The final-normed hidden states of ``tokens`` and the stack's
        aux loss (the encoder first, for an enc-dec config)."""
        cfg = self.cfg
        enc_out = enc_pos = None
        if cfg.enc_dec:
            enc_out, enc_pos = self._encode(enc_inputs)
        x, pos = self._embed_tokens(tokens)
        x, aux = T.run_stack_seq(cfg, self.blocks, x, pos, causal=True,
                                 enc_out=enc_out, enc_pos=enc_pos)
        return L.apply_norm(cfg, self.final_norm, x), aux

    @torch.no_grad()
    def logits_seq(self, tokens, enc_inputs=None):
        """Full-sequence logits (testing / eval); the plain attention path,
        which never reaches kernel 5."""
        x, _ = self._hidden(tokens, enc_inputs)
        return L.unembed(self.cfg, self.embed, x)

    # -- training forward + chunked loss -------------------------------------
    def _chunk_loss(self, xc, lc):
        """One chunk's mean cross-entropy plus the ``1e-4 · lse²`` z-loss,
        on float32 logits."""
        logits = L.unembed(self.cfg, self.embed, xc).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
        return (lse - tgt).mean() + 1e-4 * lse.square().mean()

    def loss_fn(self, batch):
        """batch: tokens (B,S), labels (B,S) [, enc_inputs (B,Se,D)].

        The JAX package's chunked loss: the sequence cut into ``n`` equal
        chunks (``loss_chunks``, lowered to a divisor of S), each chunk's
        logits in float32, the chunks' losses summed in order and divided
        by ``n``, plus the stack's MoE aux loss.  Under autograd each
        chunk is recomputed in the backward pass, so that the (B, S, V)
        logits are never held at once."""
        cfg = self.cfg
        x, aux = self._hidden(batch["tokens"], batch.get("enc_inputs"))
        B, S, D = x.shape
        n = min(cfg.loss_chunks, S)
        while S % n:
            n -= 1
        xs = x.reshape(B, n, S // n, D)
        ls = batch["labels"].reshape(B, n, S // n)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(n):
            if torch.is_grad_enabled():
                part = checkpoint(self._chunk_loss, xs[:, i], ls[:, i],
                                  use_reentrant=False)
            else:
                part = self._chunk_loss(xs[:, i], ls[:, i])
            total = total + part
        return total / n + aux

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch, capacity, dtype=torch.bfloat16,
                   cross_len: int = 0):
        return T.init_cache(self.cfg, batch, capacity, dtype,
                            device=self.device, cross_len=cross_len)

    @torch.no_grad()
    def build_cross_caches(self, cache, enc_inputs):
        """Fill each decoder layer's cross cache (``init_cache(cross_len=
        Se)``) from the encoder output of ``enc_inputs`` ``(B, Se, D)``:
        k and v of every frame, ``pos`` the frame index.  In place;
        returns ``cache``."""
        enc_out, enc_pos = self._encode(enc_inputs)
        for blk in self.blocks:
            c = T.layer_cache(cache, blk)["xattn"]
            xp = blk["xattn"]
            for name in ("k", "v"):
                c[name].copy_(L._mm("bsd,dkh->bskh", enc_out,
                                    xp[f"w{name}"]).to(c[name].dtype))
            c["pos"].copy_(enc_pos.expand(c["pos"].shape))
        return cache

    @torch.no_grad()
    def prefill(self, tokens, cache, *, chunk: int = 0):
        """Chunked prefill (chunks from :func:`prefill_chunks`). Returns
        (last_token_logits, cache).

        ``base = max(length)``, where a continued prefill starts, is one
        device→host read per call; a ``meta`` cache holds no values and
        is read as empty (the dry run's prefill starts from an empty
        cache, as the JAX cell's does)."""
        cfg = self.cfg
        S = tokens.shape[1]
        length = cache["length"]
        base = 0 if length.device.type == "meta" else int(length.max())
        last = None
        rings = [(blk.kind, T.layer_cache(cache, blk)["attn"]["k"].shape[1])
                 for blk in self.blocks if blk.kind in ("global", "local")]
        for local, n in prefill_chunks(cfg, S, chunk, rings=rings,
                                       base=base,
                                       max_seq=max(self.max_seq, 1)):
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
        """tokens_t (B,1). Returns (logits (B,V), cache).  Learned
        positions are read as ``jnp.take`` reads them: NaN past
        ``max_seq``."""
        cfg = self.cfg
        pos_t = cache["length"][:, None]
        x = L.embed(cfg, self.embed, tokens_t)
        if cfg.pos_emb == "learned":
            x = x + L.learned_pos_take(self.params["pos_emb"],
                                       pos_t).to(x.dtype)
        x, cache = T.run_stack_decode(cfg, self.blocks, cache, x, pos_t)
        x = L.apply_norm(cfg, self.final_norm, x)
        logits = L.unembed(cfg, self.embed, x)
        cache = dict(cache, length=cache["length"] + 1)
        return logits[:, 0], cache
