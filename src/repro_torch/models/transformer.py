"""Stack builder: pattern groups over heterogeneous layer kinds, with the
JAX package's trees.

Counterpart of ``repro.models.transformer``.  The archs cycle their layer
kinds (gemma3 = 5×local + 1×global, recurrentgemma = 2×rglru + 1×local,
falcon-mamba = all mamba).  The JAX package stacks each pattern
position's parameters over ``n_groups = L // len(pattern)`` and scans one
pattern cycle over the groups; the ``L % len(pattern)`` remainder layers
run unrolled after the scan.  Here every layer is its own :class:`Block`
in an ``nn.ModuleList`` in that order (group ``g``, position ``j`` is
layer ``g·P + j``; the remainder layers come after every group) and the
stack is a Python loop.  The specs keep the JAX package's tree
(``blocks/pos{j}`` with the group axis first, ``rem/rem{r}`` unstacked),
so that ``count``/``nbytes`` and the weight converter line up leaf for
leaf: block ``(g, j)`` holds ``blocks/pos{j}[g]``, remainder ``r`` holds
``rem/rem{r}``.

The cache keeps the JAX package's layout too: ``blocks/pos{j}/attn/
{k,v,pos}`` or ``blocks/pos{j}/mixer`` (a ``(conv_state, h)`` tuple)
with the group axis first, ``rem/rem{r}`` the same without it, and
``length``.  A ``local`` layer's ring holds ``min(window, capacity)``
slots.  Layer ``(g, j)`` works on views of index ``g``, and its writes
land in the stacked tensors in place.  Remat, scan segments and the
``ps.constrain*`` sharding hints have no single-device meaning and are
dropped; cross-attention (enc-dec) waits for ROADMAP item 14.4.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

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


def block_specs(cfg: ArchConfig, kind: str) -> dict:
    d: dict[str, Any] = {"ln1": L.norm_specs(cfg)}
    if kind in _ATTN:
        d["attn"] = L.attention_specs(cfg)
    elif kind == "rglru":
        d["mixer"] = S.rglru_specs(cfg)
    elif kind == "mamba":
        d["mixer"] = S.mamba_specs(cfg)
    else:
        raise ValueError(kind)
    if cfg.d_ff > 0 and kind != "mamba":
        d["ln2"] = L.norm_specs(cfg)
        d["ffn"] = M.moe_specs(cfg) if cfg.n_experts else L.mlp_specs(cfg)
    return d


def layer_slots(cfg: ArchConfig) -> list[tuple[str, str, int | None]]:
    """Each layer's ``(kind, tree key, group)`` in execution order:
    ``("local", "pos1", 3)`` is ``blocks/pos1[3]``, ``("rglru", "rem0",
    None)`` is ``rem/rem0``."""
    pattern = cfg.attn_pattern
    out = [(kind, f"pos{j}", g) for g in range(cfg.n_pattern_groups)
           for j, kind in enumerate(pattern)]
    out += [(pattern[r % len(pattern)], f"rem{r}", None)
            for r in range(cfg.n_remainder_layers)]
    return out


def model_specs(cfg: ArchConfig) -> dict:
    pattern = cfg.attn_pattern
    d: dict[str, Any] = {"embed": L.embed_specs(cfg),
                         "final_norm": L.norm_specs(cfg)}
    if cfg.n_pattern_groups:
        d["blocks"] = {f"pos{j}": _stack(block_specs(cfg, kind),
                                         cfg.n_pattern_groups)
                       for j, kind in enumerate(pattern)}
    if cfg.n_remainder_layers:
        d["rem"] = {f"rem{r}": block_specs(cfg, pattern[r % len(pattern)])
                    for r in range(cfg.n_remainder_layers)}
    return d


class ParamTree(nn.Module):
    """A nested dict of tensors as parameters (serving only: no gradients
    until training is ported), read like the JAX tree:
    ``block["mixer"]["conv"]["w"]``."""

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


class Block(ParamTree):
    """One layer's parameters (``ln1``, ``attn`` or ``mixer``, and with an
    FFN ``ln2`` and ``ffn``, the JAX package's keys), its kind and where
    its leaves and cache live in the JAX trees (``key``, ``group``)."""

    def __init__(self, tree: dict, kind: str, key: str, group: int | None):
        super().__init__(tree)
        self.kind, self.key, self.group = kind, key, group


# ---------------------------------------------------------------------------
# Block application — full sequence (logits_seq)
# ---------------------------------------------------------------------------


def _ffn(cfg: ArchConfig, p, x):
    h = L.apply_norm(cfg, p["ln2"], x)
    if cfg.n_experts:
        y, _ = M.apply_moe_auto(cfg, p["ffn"], h)
        return y
    return L.apply_mlp(cfg, p["ffn"], h)


def block_seq(cfg: ArchConfig, p, x, positions, kind: str):
    h = L.apply_norm(cfg, p["ln1"], x)
    if kind in _ATTN:
        mix = L.attention_seq(cfg, p["attn"], h, positions, kind=kind)
    else:
        fn = S.rglru_seq if kind == "rglru" else S.mamba_seq
        mix, _ = fn(cfg, p["mixer"], h)
    x = x + mix
    if "ffn" in p:
        x = x + _ffn(cfg, p, x)
    return x


def run_stack_seq(cfg: ArchConfig, blocks, x, positions):
    for blk in blocks:
        x = block_seq(cfg, blk, x, positions, blk.kind)
    return x


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def _cap(cfg: ArchConfig, kind: str, capacity: int) -> int:
    return min(cfg.window, capacity) if (kind == "local" and cfg.window) \
        else capacity


def _block_cache_init(cfg: ArchConfig, kind: str, batch: int, capacity: int,
                      dtype, device) -> dict:
    if kind in _ATTN:
        return {"attn": L.init_attn_cache(cfg, batch, _cap(cfg, kind,
                                                            capacity),
                                          dtype, device=device)}
    init = S.rglru_state_init if kind == "rglru" else S.mamba_state_init
    return {"mixer": init(cfg, batch, dtype, device=device)}


def init_cache(cfg: ArchConfig, batch: int, capacity: int,
               dtype=torch.bfloat16, *, device=None) -> dict:
    pattern = cfg.attn_pattern
    n = cfg.n_pattern_groups
    d: dict[str, Any] = {}
    if n:
        d["blocks"] = {f"pos{j}": map_tree(
            lambda a: a.expand((n,) + a.shape).contiguous(),
            _block_cache_init(cfg, kind, batch, capacity, dtype, device))
            for j, kind in enumerate(pattern)}
    if cfg.n_remainder_layers:
        d["rem"] = {f"rem{r}": _block_cache_init(
            cfg, pattern[r % len(pattern)], batch, capacity, dtype, device)
            for r in range(cfg.n_remainder_layers)}
    d["length"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return d


def cache_specs(cfg: ArchConfig, batch: int, capacity: int,
                dtype=torch.bfloat16) -> dict:
    """Annotated tree of the cache (shapes and dtypes)."""
    def annotate(kind):
        if kind in _ATTN:
            return {"attn": L.attn_cache_specs(cfg, batch,
                                               _cap(cfg, kind, capacity),
                                               dtype)}
        conv = param((batch, cfg.d_conv - 1, cfg.d_inner),
                     ("batch", "state", "ffn"), dtype=dtype, init="zeros")
        if kind == "rglru":
            h = param((batch, cfg.d_inner), ("batch", "ffn"),
                      dtype=torch.float32, init="zeros")
        else:
            h = param((batch, cfg.d_inner, cfg.ssm_state),
                      ("batch", "ffn", "state"), dtype=torch.float32,
                      init="zeros")
        return {"mixer": (conv, h)}

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
    if "ffn" in p:
        x = x + _ffn(cfg, p, x)
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
    if "ffn" in p:
        x_t = x_t + _ffn(cfg, p, x_t)
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
