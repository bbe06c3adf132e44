"""Weights and caches carried across from the JAX package's trees, and
the port's trees carried back.

The JAX package keeps parameters and caches as nested dicts (and, for
the mixers' cache states, tuples) of arrays whose ``blocks/pos{j}``
leaves carry the group axis first.  The tests hand
those trees over as numpy arrays (``jax.tree.map(np.asarray, tree)``);
nothing here imports JAX.  bfloat16 arrays arrive as numpy's ``bfloat16``
extension dtype and are moved bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .param import leaves, map_tree


def to_tensor(a: np.ndarray, device=None) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype (bfloat16 bit for bit)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bfloat16 becomes float32 (exact)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _copy(dst: torch.Tensor, src: np.ndarray, name: str) -> None:
    src_t = to_tensor(src)
    if tuple(src_t.shape) != tuple(dst.shape) or src_t.dtype != dst.dtype:
        raise ValueError(f"{name}: JAX leaf {src_t.dtype} "
                         f"{tuple(src_t.shape)} != port {dst.dtype} "
                         f"{tuple(dst.shape)}")
    dst.copy_(src_t)


@torch.no_grad()
def load_jax_params(model, tree: dict) -> None:
    """Copy the JAX package's parameter tree into ``model`` (an
    ``LModel``, whose parameters are that tree: ``blocks/pos{j}`` stacked
    over groups, ``rem/rem{r}``, whisper's ``encoder``, ``pos_emb`` and
    ``xattn`` leaves), leaf for leaf.  Every leaf must match its port
    parameter in shape and dtype, and every leaf on either side must be
    used exactly once: a port parameter missing from ``tree`` raises
    ``KeyError``, a JAX leaf with no port parameter ``ValueError``."""
    port = dict(leaves(model.param_tree()))
    for path, dst in port.items():
        a = tree
        for k in path:
            a = a[k]
        _copy(dst, a, "/".join(map(str, path)))
    unused = sorted(set(p for p, _ in leaves(tree)) - set(port), key=str)
    if unused:
        raise ValueError(f"JAX leaves with no port parameter: {unused}")


def params_to_jax(tree: dict) -> dict:
    """A tree of the port's tensors (``LModel.param_tree()``, an
    optimizer state, or both) as the JAX tree of numpy arrays, with the
    same leaf paths (bfloat16 → float32, exact): what
    ``jax.tree.map(jnp.asarray, ...)`` takes back."""
    return map_tree(to_numpy, tree)


def cache_from_jax(tree: dict, device=None) -> dict:
    """A JAX cache tree (numpy leaves) as the port's cache."""
    return map_tree(lambda a: to_tensor(a, device), tree)


def cache_to_numpy(cache: dict) -> dict:
    """The port's cache as numpy leaves (bfloat16 → float32)."""
    return map_tree(to_numpy, cache)
