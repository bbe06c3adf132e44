"""Stack builder: one block per layer, with the JAX package's trees.

Counterpart of ``repro.models.transformer`` for stacks of ``global``
attention layers with a dense MLP (``attn_pattern == ("global",)``).  The
JAX package stacks each pattern position's parameters over the groups and
scans over them; with the one-position pattern every layer is a group.
Here every layer is its own :class:`Block` in an ``nn.ModuleList`` and the
stack is a Python loop.  The specs keep the JAX package's group-stacked
tree (``blocks/pos0`` with the layer axis first), so that
``count``/``nbytes`` and the weight converter line up leaf for leaf.

The cache keeps the JAX package's layout too: ``blocks/pos0/attn/
{k,v,pos}`` with the layer axis first, and ``length``.  Layer ``i`` works
on views of index ``i``, and its ring writes land in the stacked tensors
in place.  Remat, scan segments and the ``ps.constrain*`` sharding hints
have no single-device meaning and are dropped; other layer kinds and the
remainder layers of longer patterns wait for ROADMAP item 14.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..configs.base import ArchConfig
from . import layers as L
from .param import Annotated, map_tree, param


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _stack(tree: Any, n: int) -> Any:
    return map_tree(lambda a: Annotated((n,) + a.shape,
                                        ("layers",) + a.logical_axes,
                                        dtype=a.dtype, init=a.init,
                                        scale=a.scale), tree)


def block_specs(cfg: ArchConfig) -> dict:
    d: dict[str, Any] = {"ln1": L.norm_specs(cfg),
                         "attn": L.attention_specs(cfg)}
    if cfg.d_ff > 0:
        d["ln2"] = L.norm_specs(cfg)
        d["ffn"] = L.mlp_specs(cfg)
    return d


def model_specs(cfg: ArchConfig) -> dict:
    return {"embed": L.embed_specs(cfg), "final_norm": L.norm_specs(cfg),
            "blocks": {"pos0": _stack(block_specs(cfg), cfg.n_layers)}}


def params(leaves: dict) -> nn.ParameterDict:
    """Tensors as parameters (serving only: no gradients until training
    is ported)."""
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in leaves.items()})


class Block(nn.Module):
    """One layer's parameters: ``ln1``, ``attn`` and, with an MLP, ``ln2``
    and ``ffn``, each an ``nn.ParameterDict`` with the JAX package's
    keys.  ``block["attn"]["wq"]`` reads like the JAX tree."""

    def __init__(self, tree: dict):
        super().__init__()
        self.parts = list(tree)
        for name, leaves in tree.items():
            setattr(self, name, params(leaves))

    def __getitem__(self, name: str) -> nn.ParameterDict:
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self.parts


# ---------------------------------------------------------------------------
# Block application — full sequence (logits_seq)
# ---------------------------------------------------------------------------


def block_seq(cfg: ArchConfig, p, x, positions):
    h = L.apply_norm(cfg, p["ln1"], x)
    x = x + L.attention_seq(cfg, p["attn"], h, positions)
    if "ffn" in p:
        x = x + L.apply_mlp(cfg, p["ffn"], L.apply_norm(cfg, p["ln2"], x))
    return x


def run_stack_seq(cfg: ArchConfig, blocks, x, positions):
    for blk in blocks:
        x = block_seq(cfg, blk, x, positions)
    return x


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, capacity: int,
               dtype=torch.bfloat16, *, device=None) -> dict:
    attn = L.init_attn_cache(cfg, batch, capacity, dtype, device=device)
    n = cfg.n_layers
    return {"blocks": {"pos0": {"attn": map_tree(
                lambda a: a.expand((n,) + a.shape).contiguous(), attn)}},
            "length": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}


def cache_specs(cfg: ArchConfig, batch: int, capacity: int,
                dtype=torch.bfloat16) -> dict:
    """Annotated tree of the cache (shapes and dtypes)."""
    attn = L.attn_cache_specs(cfg, batch, capacity, dtype)
    return {"blocks": {"pos0": _stack({"attn": attn}, cfg.n_layers)},
            "length": param((batch,), ("batch",), dtype=torch.int32,
                            init="zeros")}


def layer_cache(cache: dict, i: int) -> dict:
    """Layer ``i``'s cache: views into the stacked tree, so that writes to
    them land in ``cache``."""
    return map_tree(lambda a: a[i], cache["blocks"]["pos0"])


# ---------------------------------------------------------------------------
# Block application — prefill chunk / decode step
# ---------------------------------------------------------------------------


def block_append(cfg: ArchConfig, p, c, x, positions, start: int):
    h = L.apply_norm(cfg, p["ln1"], x)
    x = x + L.attention_append(cfg, p["attn"], h, positions, c["attn"],
                               start=start)
    if "ffn" in p:
        x = x + L.apply_mlp(cfg, p["ffn"], L.apply_norm(cfg, p["ln2"], x))
    return x


def block_decode(cfg: ArchConfig, p, c, x_t, pos_t):
    h = L.apply_norm(cfg, p["ln1"], x_t)
    x_t = x_t + L.attention_decode(cfg, p["attn"], h, pos_t, c["attn"])
    if "ffn" in p:
        x_t = x_t + L.apply_mlp(cfg, p["ffn"],
                                L.apply_norm(cfg, p["ln2"], x_t))
    return x_t


def run_stack_append(cfg: ArchConfig, blocks, cache, x, positions,
                     start: int):
    """A prefill chunk through every layer; the caches fill in place."""
    for i, blk in enumerate(blocks):
        x = block_append(cfg, blk, layer_cache(cache, i), x, positions,
                         start)
    return x, cache


def run_stack_decode(cfg: ArchConfig, blocks, cache, x_t, pos_t):
    """One decode step through every layer; the caches fill in place."""
    for i, blk in enumerate(blocks):
        x_t = block_decode(cfg, blk, layer_cache(cache, i), x_t, pos_t)
    return x_t, cache
