"""Weights and caches carried across from the JAX package's trees.

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
    ``LModel``): block ``(g, j)`` takes index ``g`` of ``blocks/pos{j}``'s
    leaves, remainder ``r`` the leaves of ``rem/rem{r}`` (the ``mixer``
    and MoE ``ffn`` subtrees too).  Every leaf must match its port
    parameter in shape and dtype, and every leaf on either side must be
    used exactly once."""
    used = set()
    for part in ("embed", "final_norm"):
        for path, a in leaves(tree[part]):
            _copy(getattr(model, part)[path[0]], a, f"{part}/{path[0]}")
            used.add((part,) + path)
    for i, blk in enumerate(model.blocks):
        top = ("blocks", blk.key) if blk.group is not None \
            else ("rem", blk.key)
        for path, dst in _param_leaves(blk):
            a = tree[top[0]][top[1]]
            for k in path:
                a = a[k]
            a = np.asarray(a)
            if blk.group is not None:       # the group axis comes first
                a = a[blk.group]
                path = path + (blk.group,)
            _copy(dst, a, f"layer {i} {'/'.join(map(str, top + path))}")
            used.add(top + path)
    want = set()
    for path, a in leaves(tree):
        if path[0] == "blocks":
            want.update(path + (g,) for g in range(np.shape(a)[0]))
        else:
            want.add(path)
    unused = sorted(want - used, key=str)
    if unused:
        raise ValueError(f"JAX leaves with no port parameter: {unused}")


def _param_leaves(mod, prefix: tuple = ()):
    """``(path, parameter)`` of a ``transformer.ParamTree``."""
    for name, v in mod.items():
        if isinstance(v, torch.nn.Parameter):
            yield prefix + (name,), v
        else:
            yield from _param_leaves(v, prefix + (name,))


def cache_from_jax(tree: dict, device=None) -> dict:
    """A JAX cache tree (numpy leaves) as the port's cache."""
    return map_tree(lambda a: to_tensor(a, device), tree)


def cache_to_numpy(cache: dict) -> dict:
    """The port's cache as numpy leaves (bfloat16 → float32)."""
    return map_tree(to_numpy, cache)
