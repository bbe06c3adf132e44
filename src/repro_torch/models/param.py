"""Annotated parameter specs: shape + dtype + logical axes + init.

Counterpart of ``repro.models.param``.  One tree (nested dicts) of
``Annotated`` leaves describes every parameter; :func:`materialize` turns
it into tensors with the JAX package's init rules (on the ``meta``
device, empty tensors that draw nothing).  :func:`abstract` gives the dry
run's never-allocated leaves (:class:`AbstractLeaf`: shape, dtype, the
resolved ``NamedSharding`` and the bytes a device holds), and
:func:`specs` the PartitionSpecs, through ``sharding.partition.resolve``
on each leaf's logical axes, so that the specs are the JAX package's,
leaf for leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator

import torch

from ..sharding import partition as ps


@dataclasses.dataclass(frozen=True)
class Annotated:
    shape: tuple[int, ...]
    logical_axes: tuple[str | None, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"         # 'normal' | 'zeros' | 'ones' | 'embed'
    scale: float | None = None   # stddev; None → 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"shape {self.shape} and axes "
                             f"{self.logical_axes} differ in rank")


def param(shape, axes, *, dtype=torch.bfloat16, init="normal", scale=None):
    return Annotated(tuple(int(s) for s in shape), tuple(axes),
                     dtype=dtype, init=init, scale=scale)


def leaves(tree: Any, prefix: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs of a tree of dicts and tuples in sorted key
    order, a tuple's items by index (the order ``jax.tree`` flattens
    them in); a ``PartitionSpec`` is a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    elif isinstance(tree, tuple) and not isinstance(tree, ps.PartitionSpec):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def unflatten(pairs) -> dict:
    """The nested dict of ``(path, leaf)`` pairs (``leaves``' inverse for
    trees of dicts)."""
    out: dict = {}
    for path, v in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def map_tree(fn, tree: Any) -> Any:
    """``fn`` applied to every leaf of a tree of dicts and tuples (the
    mixers' cache states are ``(conv_state, h)`` tuples)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree, ps.PartitionSpec):
        return tuple(map_tree(fn, v) for v in tree)
    return fn(tree)


def materialize(tree: Any, generator: torch.Generator, *, device,
                dtype: torch.dtype | None = None) -> Any:
    """Real parameter init: ``zeros``, ``ones``, or a normal draw with
    ``std = scale or fan_in ** -0.5`` (fan_in is ``shape[0]`` for
    ``embed``, else the product of all but the last dim), drawn in
    float32 on ``device`` from ``generator`` and cast to ``dtype`` or the
    leaf's own.  Leaves are drawn in sorted path order, a leaf stacked
    over layers (logical axis ``layers`` first) one layer at a time, so
    that no float32 copy of a whole stack exists; one seed gives one
    tree; the numbers differ from ``jax.random``'s.  On the ``meta``
    device every leaf is an empty tensor and ``generator`` may be None
    (a generator cannot live there)."""
    if torch.device(device).type == "meta":
        return map_tree(lambda ann: torch.empty(
            ann.shape, dtype=dtype or ann.dtype, device="meta"), tree)

    def draw(shape, std, dt) -> torch.Tensor:
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(std).to(dt)

    def one(ann: Annotated) -> torch.Tensor:
        dt = dtype or ann.dtype
        if ann.init == "zeros":
            return torch.zeros(ann.shape, dtype=dt, device=device)
        if ann.init == "ones":
            return torch.ones(ann.shape, dtype=dt, device=device)
        fan_in = ann.shape[0] if ann.init == "embed" else (
            math.prod(ann.shape[:-1]) or 1)
        std = ann.scale if ann.scale is not None else fan_in ** -0.5
        if ann.logical_axes[0] != "layers":
            return draw(ann.shape, std, dt)
        out = torch.empty(ann.shape, dtype=dt, device=device)
        for g in range(ann.shape[0]):
            out[g] = draw(ann.shape[1:], std, dt)
        return out

    return unflatten((path, one(ann)) for path, ann in leaves(tree))


@dataclasses.dataclass(frozen=True)
class AbstractLeaf:
    """A never-allocated leaf (the counterpart of ``ShapeDtypeStruct``
    with a sharding): the global shape and dtype, and the
    ``NamedSharding`` that places it."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    sharding: Any

    @property
    def local_shape(self) -> tuple[int, ...]:
        return self.sharding.shard_shape(self.shape)

    @property
    def nbytes(self) -> int:
        """Global bytes."""
        return math.prod(self.shape) * self.dtype.itemsize

    @property
    def local_nbytes(self) -> int:
        """Bytes one device of the mesh holds."""
        return self.sharding.local_nbytes(self.shape, self.dtype)

    def to_meta(self) -> torch.Tensor:
        """An empty ``meta`` tensor of the global shape and dtype."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def abstract(tree: Any, mesh, rules, *, fsdp: bool = True) -> Any:
    """A tree of :class:`AbstractLeaf` with resolved shardings (the dry
    run's path: nothing is allocated)."""
    info = ps.MeshInfo.from_mesh(mesh)

    def one(ann: Annotated) -> AbstractLeaf:
        spec = ps.resolve(ann.shape, ann.logical_axes, info, rules, fsdp=fsdp)
        return AbstractLeaf(ann.shape, ann.dtype, ps.NamedSharding(mesh, spec))

    return map_tree(one, tree)


def specs(tree: Any, mesh, rules, *, fsdp: bool = True) -> Any:
    """The PartitionSpec of every leaf."""
    return ps.tree_specs(tree, mesh, rules, fsdp=fsdp)


def nbytes(tree: Any) -> int:
    return sum(math.prod(a.shape) * a.dtype.itemsize
               for _, a in leaves(tree))


def count(tree: Any) -> int:
    return sum(math.prod(a.shape) for _, a in leaves(tree))
