"""Logical-axis sharding resolver (the communication manager's planning half).

Counterpart of ``repro.sharding.partition``.  Every parameter/activation
dim carries a *logical axis name*; a rule table maps logical names to
mesh-axis candidates in priority order.  :func:`resolve` assigns the
first candidate whose size divides the dim and whose mesh axes are unused
in this spec — the divisibility-aware fallback that lets one rule table
cover all ten assigned architectures (kv=2..20, heads=8..64,
experts=8/64, vocab 51866..262144).  The tables and the resolver are the
JAX package's, rule for rule.

The port has no SPMD partitioner.  A :class:`PartitionSpec` is a tuple
(items ``None``, a mesh-axis name or a tuple of names, as JAX's ``P``),
and a :class:`NamedSharding` places a spec on a port mesh
(``launch.mesh.Mesh``, whose devices may repeat): it gives a global
shape's local shape, splits a tensor into its shards in the mesh's device
order and :func:`unshard` joins them back.  The planner
(``launch/dryrun.py``) reads the specs for its per-device bytes; the
checkpoint restore places shards with them; the expert-parallel MoE
(``models.moe.apply_moe_shardmap``) reads the ambient mesh that
:func:`set_mesh` installs.

``constrain_batch``, ``constrain_residual`` and ``constrain`` compute the
JAX package's divisibility-checked constraint spec under the ambient mesh
and return their input unchanged.  JAX's ``with_sharding_constraint``
changes no value either; it only steers XLA's partitioner, which the port
does not have, so the model code does not call them.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Mapping, Sequence

import numpy as np
import torch

# A rule value is a tuple of candidates; each candidate is a mesh-axis name
# or a tuple of mesh-axis names (joint sharding of one dim).
Rules = Mapping[str, Sequence[Any]]

# ---------------------------------------------------------------------------
# Standard rule tables. 'pod' is pure DP and therefore appears only on batch
# (training) — cross-pod traffic is one gradient all-reduce per step.
# ---------------------------------------------------------------------------

TRAIN_RULES: Rules = {
    "batch":      (("pod", "data"), "data"),
    "seq":        ("model",),              # only used when attn can't shard heads
    "embed":      ("fsdp_data",),          # param-only FSDP tag (see below)
    "heads":      ("model",),
    "kv_heads":   ("model",),
    "head_dim":   (),
    "ffn":        ("model",),
    "vocab":      ("model",),
    "experts":    ("model",),
    "expert_ffn": ("model",),
    "layers":     (),
    "state":      (),                      # ssm state / conv taps
    "route_grp":  ("data",),               # MoE routing groups follow batch
}

# Params additionally get FSDP over 'data' on their largest remaining dim.
FSDP_AXIS = "data"

PREFILL_RULES: Rules = dict(TRAIN_RULES) | {
    "batch": (("pod", "data"), "data"),
    "cache_seq": ("model",),
}

# Decode is weight-stationary 2D TP: activations are tiny (B×1×D) and stay
# replicated; weights shard over data×model (embed dim takes 'data' — no
# FSDP gathers per token); the KV cache shards batch over 'data' and seq
# over 'model'.
DECODE_RULES: Rules = dict(TRAIN_RULES) | {
    "batch": (("pod", "data"), "data"),   # cache batch (activations bypass)
    "embed": ("data",),          # 2D TP: second weight dim over 'data'
    "cache_seq": ("model", ("data", "model")),
    "cache_kv": ("model",),
}


class PartitionSpec(tuple):
    """A dim-by-dim sharding spec: each item ``None`` (replicated), a
    mesh-axis name, or a tuple of names (the dim split over their
    product, the first name major).  Missing trailing items are
    ``None``."""

    def __new__(cls, *items):
        return super().__new__(cls, items)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(i) for i in self) + ")"


P = PartitionSpec


def _axes(item) -> tuple[str, ...]:
    if item is None:
        return ()
    return (item,) if isinstance(item, str) else tuple(item)


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    axis_sizes: dict[str, int]

    @classmethod
    def from_mesh(cls, mesh) -> "MeshInfo":
        return cls(dict(zip(mesh.axis_names, mesh.devices.shape)))

    def size(self, axes) -> int:
        if isinstance(axes, str):
            return self.axis_sizes.get(axes, 0)
        return int(np.prod([self.axis_sizes.get(a, 0) for a in axes]))

    def has(self, axes) -> bool:
        if isinstance(axes, str):
            return axes in self.axis_sizes
        return all(a in self.axis_sizes for a in axes)


def resolve(
    shape: Sequence[int],
    logical_axes: Sequence[str | None],
    mesh,
    rules: Rules,
    *,
    fsdp: bool = False,
    min_fsdp_dim: int = 1024,
) -> PartitionSpec:
    """Map each dim's logical axis to mesh axes (priority + divisibility)."""
    info = mesh if isinstance(mesh, MeshInfo) else MeshInfo.from_mesh(mesh)
    if len(shape) != len(logical_axes):
        raise ValueError(f"shape {tuple(shape)} and axes "
                         f"{tuple(logical_axes)} differ in rank")
    used: set[str] = set()
    spec: list[Any] = []
    for dim, name in zip(shape, logical_axes):
        assigned = None
        for cand in (rules.get(name, ()) if name else ()):
            axes = (cand,) if isinstance(cand, str) else tuple(cand)
            if not info.has(axes):
                continue
            if any(a in used for a in axes):
                continue
            sz = info.size(axes)
            if sz > 1 and dim % sz == 0:
                assigned = cand if isinstance(cand, str) else tuple(axes)
                used.update(axes)
                break
        spec.append(assigned)
    # Vocab tables opt out of FSDP: they are small once vocab-sharded, and
    # FSDP on their embed dim makes the embedding-gradient scatter replicate
    # its (B,S,D) cotangent (measured ~4.8 GiB/device fp32 buffers).
    if fsdp and "vocab" in logical_axes:
        fsdp = False
    if fsdp and info.has(FSDP_AXIS) and FSDP_AXIS not in used:
        # ZeRO-3: shard the largest eligible remaining dim over 'data'
        fs = info.size(FSDP_AXIS)
        best, best_dim = None, min_fsdp_dim - 1
        for i, (dim, cur) in enumerate(zip(shape, spec)):
            if cur is None and dim % fs == 0 and dim > best_dim:
                best, best_dim = i, dim
        if best is not None:
            spec[best] = FSDP_AXIS
    return PartitionSpec(*spec)


def tree_specs(shapes: Any, mesh, rules: Rules, *, fsdp: bool = False
               ) -> Any:
    """Map a tree of annotated shapes (``models.param.Annotated`` leaves)
    to a tree of PartitionSpecs."""
    from ..models.param import map_tree
    info = MeshInfo.from_mesh(mesh)
    return map_tree(lambda ann: resolve(ann.shape, ann.logical_axes, info,
                                        rules, fsdp=fsdp), shapes)


class NamedSharding:
    """A :class:`PartitionSpec` placed on a port mesh: device ``i`` of the
    mesh (C order over ``mesh.devices``) holds the block of a global
    tensor that its mesh coordinates select along each sharded dim."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        names = tuple(mesh.axis_names)
        for item in self.spec:
            for a in _axes(item):
                if a not in names:
                    raise ValueError(f"spec {self.spec} names axis {a!r}, "
                                     f"not one of the mesh's {names}")

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={self._sizes()}, spec={self.spec})"

    def _items(self, ndim: int) -> list[tuple[str, ...]]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} is longer than rank {ndim}")
        return [_axes(i) for i in self.spec] + [()] * (ndim - len(self.spec))

    def _sizes(self) -> dict[str, int]:
        return dict(zip(self.mesh.axis_names, self.mesh.devices.shape))

    def shard_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The local shape a device holds of a global ``shape``."""
        sizes = self._sizes()
        out = []
        for dim, axes in zip(shape, self._items(len(shape))):
            n = math.prod(sizes[a] for a in axes)
            if dim % n:
                raise ValueError(f"dim {dim} does not split over {axes} "
                                 f"({n} shards)")
            out.append(dim // n)
        return tuple(out)

    def local_nbytes(self, shape: Sequence[int], dtype: torch.dtype) -> int:
        return math.prod(self.shard_shape(shape)) * dtype.itemsize

    def shard_slices(self, shape: Sequence[int]
                     ) -> list[tuple[torch.device, tuple[slice, ...]]]:
        """``(device, index)`` of every device of the mesh in C order:
        ``global[index]`` is that device's shard."""
        names = list(self.mesh.axis_names)
        sizes = self._sizes()
        local = self.shard_shape(shape)
        items = self._items(len(shape))
        out = []
        for coord in np.ndindex(self.mesh.devices.shape):
            pos = dict(zip(names, coord))
            index = []
            for n_loc, axes in zip(local, items):
                k = 0
                for a in axes:                  # the first axis major
                    k = k * sizes[a] + pos[a]
                index.append(slice(k * n_loc, (k + 1) * n_loc))
            out.append((self.mesh.devices[coord], tuple(index)))
        return out

    def split(self, t: torch.Tensor) -> list[torch.Tensor]:
        """``t``'s shards, one a device of the mesh in C order, each a copy
        on its device (a replicated dim copies the whole extent)."""
        out = []
        for dev, index in self.shard_slices(t.shape):
            part = t[index]
            out.append(torch.empty(part.shape, dtype=t.dtype,
                                   device=dev).copy_(part))
        return out


def unshard(shards: Sequence[torch.Tensor], sharding: NamedSharding
            ) -> torch.Tensor:
    """:meth:`NamedSharding.split`'s inverse: the global tensor from its
    shards (in the mesh's device order), on the first shard's device.
    Replicas of a block must agree; the last one written wins."""
    shards = list(shards)
    n = math.prod(sharding.mesh.devices.shape)
    if len(shards) != n:
        raise ValueError(f"{len(shards)} shards for a mesh of {n} devices")
    sizes = sharding._sizes()
    items = sharding._items(shards[0].dim())
    shape = [d * math.prod(sizes[a] for a in axes)
             for d, axes in zip(shards[0].shape, items)]
    out = torch.empty(shape, dtype=shards[0].dtype, device=shards[0].device)
    for (_, index), part in zip(sharding.shard_slices(shape), shards):
        out[index].copy_(part)
    return out


def named_shardings(specs: Any, mesh) -> Any:
    """A tree of PartitionSpecs to a tree of :class:`NamedSharding`."""
    if isinstance(specs, PartitionSpec):
        return NamedSharding(mesh, specs)
    if isinstance(specs, dict):
        return {k: named_shardings(v, mesh) for k, v in specs.items()}
    if isinstance(specs, tuple):
        return tuple(named_shardings(v, mesh) for v in specs)
    return specs


# ---------------------------------------------------------------------------
# The ambient mesh and the activation constraints
# ---------------------------------------------------------------------------

_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=(None, None))


@contextlib.contextmanager
def set_mesh(mesh, *, comm=None):
    """Install ``mesh`` (a ``launch.mesh.Mesh``) as the ambient mesh for
    the ``with`` block, with an optional ``core.comm.CommManager`` whose
    stats record the collectives that run under it."""
    token = _AMBIENT.set((mesh, comm))
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def get_mesh():
    """The ambient mesh; ``None`` when no mesh is set."""
    return _AMBIENT.get()[0]


def get_comm():
    """The ambient mesh's ``CommManager``; ``None`` when none was given."""
    return _AMBIENT.get()[1]


def _ambient_axes() -> dict[str, int]:
    m = get_mesh()
    if m is None or not m.axis_names:
        return {}
    return dict(zip(m.axis_names, m.devices.shape))


def constraint_spec(shape: Sequence[int], spec_axes: Sequence[Any]
                    ) -> PartitionSpec | None:
    """The JAX package's divisibility-checked constraint spec of a tensor
    of ``shape`` under the ambient mesh (``None`` without one): items may
    be None, a mesh axis name, or a tuple of names; a tuple drops its
    leading names until the dim divides."""
    axes = _ambient_axes()
    if not axes:
        return None
    out = []
    used: set[str] = set()
    for dim, cand in zip(shape, spec_axes):
        ok = None
        if cand is not None:
            names = (cand,) if isinstance(cand, str) else tuple(cand)
            names = tuple(a for a in names if a in axes and a not in used)
            while names:
                sz = int(np.prod([axes[a] for a in names]))
                if sz > 1 and dim % sz == 0:
                    ok = names[0] if len(names) == 1 else names
                    used.update(names)
                    break
                names = names[1:]
        out.append(ok)
    return PartitionSpec(*out)


def constrain(x: torch.Tensor, spec_axes: Sequence[Any]) -> torch.Tensor:
    """Value no-op: ``x`` unchanged (see the module docstring)."""
    constraint_spec(x.shape, spec_axes)
    return x


def constrain_batch(x: torch.Tensor, *, extra: tuple = ()) -> torch.Tensor:
    """Value no-op pinning dim 0 to the batch mesh axes."""
    return constrain(x, [("pod", "data"), *extra])


def constrain_residual(x: torch.Tensor) -> torch.Tensor:
    """Value no-op: the residual stream's (batch → ('pod','data'), seq →
    'model') sequence-parallel spec."""
    return constrain(x, [("pod", "data"), "model", None])
