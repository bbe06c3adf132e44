"""Stack builder: pattern groups over heterogeneous layer kinds, with the
JAX package's trees.

Counterpart of ``repro.models.transformer``.  The archs cycle their layer
kinds (gemma3 = 5×local + 1×global, recurrentgemma = 2×rglru + 1×local,
falcon-mamba = all mamba, whisper = an encoder and a decoder of
``global`` layers).  The JAX package stacks each pattern position's
parameters over ``n_groups = L // len(pattern)`` and scans one pattern
cycle over the groups; the ``L % len(pattern)`` remainder layers run
unrolled after the scan.  The port keeps that tree as its parameters: a
:class:`ParamTree` of the JAX leaves (``blocks/pos{j}`` with the group
axis first, ``rem/rem{r}`` unstacked, whisper's ``encoder/stack`` the
same), so that ``count``/``nbytes``, the weight converter, the optimizer
and the checkpoints line up leaf for leaf.  Each layer is a
:class:`Block`, a view of its slice of that tree (layer ``(g, j)`` reads
index ``g`` of ``blocks/pos{j}``'s leaves), and the stack is a Python
loop over the blocks in execution order (group ``g``, position ``j`` is
layer ``g·P + j``; the remainder layers come after every group).  A
block's leaves are views made on each read, so under autograd the
gradients land in the stacked leaves, as ``jax.grad`` of the scan gives
them.

The cache keeps the JAX package's layout too: ``blocks/pos{j}/attn/
{k,v,pos}``, ``blocks/pos{j}/xattn/{k,v,pos}`` (the decoder's cross
caches, ``cross_len`` slots) or ``blocks/pos{j}/mixer`` (a ``(conv_state,
h)`` tuple) with the group axis first, ``rem/rem{r}`` the same without
it, and ``length``.  A ``local`` layer's ring holds ``min(window,
capacity)`` slots.  Layer ``(g, j)`` works on views of index ``g``, and
its writes land in the stacked tensors in place.  ``cfg.remat``
recomputes a pattern cycle in the backward pass as ``jax.checkpoint``
does (``remat_policy="dots"`` keeps the products); scan segments and the
``ps.constrain*`` sharding hints have no single-device meaning and are
dropped.
"""
from __future__ import annotations

import functools
import itertools
from typing import Any

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..configs.base import ArchConfig
from . import layers as L
from . import moe as M
from . import ssm as S
from .param import Annotated, map_tree, param

_ATTN = ("global", "local")


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _stack(tree: Any, n: int) -> Any:
    return map_tree(lambda a: Annotated((n,) + a.shape,
                                        ("layers",) + a.logical_axes,
                                        dtype=a.dtype, init=a.init,
                                        scale=a.scale), tree)


def block_specs(cfg: ArchConfig, kind: str, *, cross: bool = False) -> dict:
    d: dict[str, Any] = {"ln1": L.norm_specs(cfg)}
    if kind in _ATTN:
        d["attn"] = L.attention_specs(cfg)
    elif kind == "rglru":
        d["mixer"] = S.rglru_specs(cfg)
    elif kind == "mamba":
        d["mixer"] = S.mamba_specs(cfg)
    else:
        raise ValueError(kind)
    if cross:
        d["ln_x"] = L.norm_specs(cfg)
        d["xattn"] = L.attention_specs(cfg, cross=True)
    if cfg.d_ff > 0 and kind != "mamba":
        d["ln2"] = L.norm_specs(cfg)
        d["ffn"] = M.moe_specs(cfg) if cfg.n_experts else L.mlp_specs(cfg)
    return d


def stack_specs(cfg: ArchConfig, *, cross: bool = False,
                n_layers: int | None = None,
                pattern: tuple[str, ...] | None = None) -> dict:
    n_layers = n_layers if n_layers is not None else cfg.n_layers
    pattern = pattern or cfg.attn_pattern
    n_groups = n_layers // len(pattern)
    rem = n_layers % len(pattern)
    d: dict[str, Any] = {}
    if n_groups:
        d["blocks"] = {
            f"pos{j}": _stack(block_specs(cfg, kind, cross=cross), n_groups)
            for j, kind in enumerate(pattern)}
    if rem:
        d["rem"] = {f"rem{r}": block_specs(cfg, pattern[r % len(pattern)],
                                           cross=cross)
                    for r in range(rem)}
    return d


def model_specs(cfg: ArchConfig, *, max_seq: int = 0) -> dict:
    d: dict[str, Any] = {"embed": L.embed_specs(cfg),
                         "final_norm": L.norm_specs(cfg)}
    d.update(stack_specs(cfg, cross=cfg.enc_dec))
    if cfg.pos_emb == "learned":
        d["pos_emb"] = L.learned_pos_specs(cfg, max(max_seq, 1))
    if cfg.enc_dec:
        enc = stack_specs(cfg, cross=False, n_layers=cfg.n_enc_layers,
                          pattern=("global",))
        d["encoder"] = {"stack": enc, "final_norm": L.norm_specs(cfg)}
        if cfg.pos_emb == "learned":
            d["encoder"]["pos_emb"] = L.learned_pos_specs(cfg,
                                                          max(max_seq, 1))
    return d


def layer_slots(cfg: ArchConfig, n_layers: int | None = None,
                pattern: tuple[str, ...] | None = None
                ) -> list[tuple[str, str, int | None]]:
    """Each layer's ``(kind, tree key, group)`` in execution order:
    ``("local", "pos1", 3)`` is ``blocks/pos1[3]``, ``("rglru", "rem0",
    None)`` is ``rem/rem0``.  The decoder's by default; whisper's encoder
    is ``layer_slots(cfg, cfg.n_enc_layers, ("global",))``."""
    n_layers = n_layers if n_layers is not None else cfg.n_layers
    pattern = pattern or cfg.attn_pattern
    out = [(kind, f"pos{j}", g) for g in range(n_layers // len(pattern))
           for j, kind in enumerate(pattern)]
    out += [(pattern[r % len(pattern)], f"rem{r}", None)
            for r in range(n_layers % len(pattern))]
    return out


class ParamTree(nn.Module):
    """A nested dict of tensors as parameters, read like the JAX tree:
    ``tree["blocks"]["pos0"]["mixer"]["conv"]["w"]``.  Every parameter is
    registered with ``requires_grad=False``: serving needs no gradients,
    and training turns them on (``train.train_loop.make_train_step``)."""

    def __init__(self, tree: dict):
        super().__init__()
        self.parts = list(tree)
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self.parts

    def items(self):
        return ((name, self[name]) for name in self.parts)

    def tree(self) -> dict:
        """The parameters as a nested dict (the JAX tree's keys)."""
        return {name: v.tree() if isinstance(v, ParamTree) else v
                for name, v in self.items()}


class _Slice:
    """One layer's view of a stacked subtree: index ``group`` of each leaf
    (the leaf itself where ``group`` is None), made anew on each read, so
    that autograd reaches the stacked leaf."""

    def __init__(self, node: ParamTree, group: int | None):
        self._node, self._group = node, group

    def __getitem__(self, name: str):
        v = self._node[name]
        if isinstance(v, ParamTree):
            return _Slice(v, self._group)
        return v if self._group is None else v[self._group]

    def __contains__(self, name: str) -> bool:
        return name in self._node

    def items(self):
        return ((name, self[name]) for name in self._node.parts)


class Block(_Slice):
    """One layer of a stack (``stack`` the ParamTree holding ``blocks``
    and ``rem``): its parameters (``ln1``, ``attn`` or ``mixer``, with
    cross-attention ``ln_x`` and ``xattn``, with an FFN ``ln2`` and
    ``ffn``, the JAX package's keys), its kind and where its leaves and
    cache live in the JAX trees (``key``, ``group``)."""

    def __init__(self, stack: ParamTree, kind: str, key: str,
                 group: int | None):
        super().__init__(stack["blocks" if group is not None else "rem"][key],
                         group)
        self.kind, self.key, self.group = kind, key, group


def stack_blocks(cfg: ArchConfig, stack: ParamTree,
                 n_layers: int | None = None,
                 pattern: tuple[str, ...] | None = None) -> list[Block]:
    """The blocks of ``stack`` in execution order (``layer_slots``)."""
    return [Block(stack, kind, key, g)
            for kind, key, g in layer_slots(cfg, n_layers, pattern)]


# ---------------------------------------------------------------------------
# Block application — full sequence (logits_seq, the loss, the encoder)
# ---------------------------------------------------------------------------


def _ffn(cfg: ArchConfig, p, x):
    """The FFN's output and its aux loss (MoE; 0 for a dense MLP)."""
    h = L.apply_norm(cfg, p["ln2"], x)
    if cfg.n_experts:
        return M.apply_moe_auto(cfg, p["ffn"], h)
    return L.apply_mlp(cfg, p["ffn"], h), None


def block_seq(cfg: ArchConfig, p, x, positions, kind: str, *,
              causal: bool = True, enc_out=None, enc_pos=None):
    """Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = L.apply_norm(cfg, p["ln1"], x)
    if kind in _ATTN:
        mix = L.attention_seq(cfg, p["attn"], h, positions, kind=kind,
                              causal=causal)
    else:
        fn = S.rglru_seq if kind == "rglru" else S.mamba_seq
        mix, _ = fn(cfg, p["mixer"], h)
    x = x + mix
    if enc_out is not None:
        h = L.apply_norm(cfg, p["ln_x"], x)
        x = x + L.attention_seq(cfg, p["xattn"], h, positions, kv_x=enc_out,
                                kv_positions=enc_pos)
    if "ffn" in p:
        y, a = _ffn(cfg, p, x)
        x = x + y
        if a is not None:
            aux = a
    return x, aux


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the products' outputs, recompute the
    rest (``jax.checkpoint_policies.dots_saveable``)."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig, fn, x):
    """``fn(x)`` recomputed in the backward pass (``jax.checkpoint``):
    nothing of it kept, or with ``remat_policy="dots"`` its products."""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return ckpt.checkpoint(fn, x, use_reentrant=False, **kw)


def run_stack_seq(cfg: ArchConfig, blocks, x, positions, *,
                  causal: bool = True, enc_out=None, enc_pos=None):
    """Every block in order; returns (x, total_aux).  Under autograd with
    ``cfg.remat`` each pattern cycle (the blocks of one group) is
    recomputed as a unit in the backward pass, as the JAX package's
    scan body; the remainder layers (group None) are not, as there."""
    total_aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for g, cycle in itertools.groupby(blocks, key=lambda b: b.group):
        def run(x, cycle=tuple(cycle)):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for blk in cycle:
                x, a = block_seq(cfg, blk, x, positions, blk.kind,
                                 causal=causal, enc_out=enc_out,
                                 enc_pos=enc_pos)
                aux = aux + a
            return x, aux

        x, a = _remat(cfg, run, x) if remat and g is not None else run(x)
        total_aux = total_aux + a
    return x, total_aux


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def _cap(cfg: ArchConfig, kind: str, capacity: int) -> int:
    return min(cfg.window, capacity) if (kind == "local" and cfg.window) \
        else capacity


def _block_cache_init(cfg: ArchConfig, kind: str, batch: int, capacity: int,
                      dtype, device, cross_len: int = 0) -> dict:
    if kind in _ATTN:
        c = {"attn": L.init_attn_cache(cfg, batch, _cap(cfg, kind, capacity),
                                       dtype, device=device)}
    else:
        init = S.rglru_state_init if kind == "rglru" else S.mamba_state_init
        c = {"mixer": init(cfg, batch, dtype, device=device)}
    if cross_len:
        c["xattn"] = L.init_attn_cache(cfg, batch, cross_len, dtype,
                                       device=device)
    return c


def init_cache(cfg: ArchConfig, batch: int, capacity: int,
               dtype=torch.bfloat16, *, device=None,
               cross_len: int = 0) -> dict:
    """The decoder's cache; ``cross_len`` adds each layer's cross cache
    (``xattn``, filled by ``LModel.build_cross_caches``)."""
    pattern = cfg.attn_pattern
    n = cfg.n_pattern_groups
    d: dict[str, Any] = {}
    if n:
        d["blocks"] = {f"pos{j}": map_tree(
            lambda a: a.expand((n,) + a.shape).contiguous(),
            _block_cache_init(cfg, kind, batch, capacity, dtype, device,
                              cross_len))
            for j, kind in enumerate(pattern)}
    if cfg.n_remainder_layers:
        d["rem"] = {f"rem{r}": _block_cache_init(
            cfg, pattern[r % len(pattern)], batch, capacity, dtype, device,
            cross_len)
            for r in range(cfg.n_remainder_layers)}
    d["length"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return d


def cache_specs(cfg: ArchConfig, batch: int, capacity: int,
                dtype=torch.bfloat16, cross_len: int = 0) -> dict:
    """Annotated tree of the cache (shapes and dtypes)."""
    def annotate(kind):
        if kind in _ATTN:
            c = {"attn": L.attn_cache_specs(cfg, batch,
                                            _cap(cfg, kind, capacity),
                                            dtype)}
        else:
            conv = param((batch, cfg.d_conv - 1, cfg.d_inner),
                         ("batch", "state", "ffn"), dtype=dtype,
                         init="zeros")
            if kind == "rglru":
                h = param((batch, cfg.d_inner), ("batch", "ffn"),
                          dtype=torch.float32, init="zeros")
            else:
                h = param((batch, cfg.d_inner, cfg.ssm_state),
                          ("batch", "ffn", "state"), dtype=torch.float32,
                          init="zeros")
            c = {"mixer": (conv, h)}
        if cross_len:
            c["xattn"] = L.attn_cache_specs(cfg, batch, cross_len, dtype)
        return c

    pattern = cfg.attn_pattern
    d: dict[str, Any] = {}
    if cfg.n_pattern_groups:
        d["blocks"] = {f"pos{j}": _stack(annotate(kind),
                                         cfg.n_pattern_groups)
                       for j, kind in enumerate(pattern)}
    if cfg.n_remainder_layers:
        d["rem"] = {f"rem{r}": annotate(pattern[r % len(pattern)])
                    for r in range(cfg.n_remainder_layers)}
    d["length"] = param((batch,), ("batch",), dtype=torch.int32,
                        init="zeros")
    return d


def layer_cache(cache: dict, blk: Block) -> dict:
    """A block's cache: views into the stacked tree (index ``group`` of
    ``blocks/pos{j}``) or the remainder's own, so that writes to them land
    in ``cache``."""
    if blk.group is None:
        return cache["rem"][blk.key]
    return map_tree(lambda a: a[blk.group], cache["blocks"][blk.key])


def _write_state(c: dict, state) -> None:
    """A mixer's new ``(conv_state, h)`` into its cache views."""
    for dst, src in zip(c["mixer"], state):
        dst.copy_(src)


# ---------------------------------------------------------------------------
# Block application — prefill chunk / decode step
# ---------------------------------------------------------------------------


def block_append(cfg: ArchConfig, p, c, x, positions, start: int,
                 kind: str):
    h = L.apply_norm(cfg, p["ln1"], x)
    if kind in _ATTN:
        mix = L.attention_append(cfg, p["attn"], h, positions, c["attn"],
                                 kind=kind, start=start)
    else:
        fn = S.rglru_seq if kind == "rglru" else S.mamba_seq
        conv_state, h0 = c["mixer"]
        mix, state = fn(cfg, p["mixer"], h, conv_state=conv_state, h0=h0)
        _write_state(c, state)
    x = x + mix
    if "xattn" in c:
        h = L.apply_norm(cfg, p["ln_x"], x)
        x = x + L.attention_cross(cfg, p["xattn"], h, positions, c["xattn"])
    if "ffn" in p:
        x = x + _ffn(cfg, p, x)[0]
    return x


def block_decode(cfg: ArchConfig, p, c, x_t, pos_t, kind: str):
    h = L.apply_norm(cfg, p["ln1"], x_t)
    if kind in _ATTN:
        mix = L.attention_decode(cfg, p["attn"], h, pos_t, c["attn"],
                                 kind=kind)
    else:
        fn = S.rglru_decode if kind == "rglru" else S.mamba_decode
        mix, state = fn(cfg, p["mixer"], h, c["mixer"])
        _write_state(c, state)
    x_t = x_t + mix
    if "xattn" in c:
        h = L.apply_norm(cfg, p["ln_x"], x_t)
        x_t = x_t + L.attention_decode(cfg, p["xattn"], h, pos_t, None,
                                       cross_cache=c["xattn"])
    if "ffn" in p:
        x_t = x_t + _ffn(cfg, p, x_t)[0]
    return x_t


def run_stack_append(cfg: ArchConfig, blocks, cache, x, positions,
                     start: int):
    """A prefill chunk through every layer; the caches fill in place."""
    for blk in blocks:
        x = block_append(cfg, blk, layer_cache(cache, blk), x, positions,
                         start, blk.kind)
    return x, cache


def run_stack_decode(cfg: ArchConfig, blocks, cache, x_t, pos_t):
    """One decode step through every layer; the caches fill in place."""
    for blk in blocks:
        x_t = block_decode(cfg, blk, layer_cache(cache, blk), x_t, pos_t,
                           blk.kind)
    return x_t, cache
