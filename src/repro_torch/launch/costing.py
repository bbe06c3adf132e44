"""Roofline cost model of a cell, from a trace on the ``meta`` device.

Counterpart of ``repro.launch.costing``.  The JAX package compiles
unrolled variants of a step at 2 and 3 pattern cycles and extrapolates,
because XLA's ``cost_analysis`` counts a ``while`` body once.  The port
has no XLA: it runs the cell's step once on ``meta`` tensors
(``cells.trace_cell``), at full width and full depth, so every layer and
microbatch is in the trace and nothing is extrapolated.  A ``meta`` op
computes only its result's shape, so a trace allocates nothing.  One
:class:`Tracker` (a ``TorchDispatchMode``) sees every ATen op of it and
counts:

* **FLOPs** with ``torch.utils.flop_counter``'s formulas (the
  ``FlopCounterMode`` registry: matrix products, convolutions and
  attention; elementwise work counts 0).
* **Bytes**: each op's tensor operands and results, once each (views
  move nothing).  No fusion is assumed, so this is an upper bound on what
  a fused program moves.
* **Live bytes**: every storage an op creates, from its creation until
  it is freed (a ``weakref.finalize`` on the storage), and the peak of
  their sum.  Arguments (parameters, optimizer state, caches, batch) are
  not counted there.  A tensor of a parameter's global shape (a
  gradient, its accumulator, an optimizer temporary) is counted at that
  parameter's local shard size: ``make_train_step(grad_specs=)`` pins
  them to the parameters' shardings.

A trace runs at the per-device batch and at full width, one microbatch
of a train step (the accumulators live across microbatches and each
microbatch's activations are freed before the next, so one microbatch
shows the step's peak).  So, per device:

* ``flops_dev``: the global step's FLOPs, ``n_micro`` times the
  microbatch's at the per-device batch times the batch shards, divided
  by the mesh size: a perfect split;
* ``bytes_dev``: ``n_micro`` times the microbatch's bytes at the
  per-device batch and full width, plus the optimizer's over the local
  shards.  Full width makes it an upper bound wherever the weights or
  activations are ``model``-sharded;
* ``coll_dev``: counted from the plan (:func:`collective_plan`), not
  from a program: the port has no HLO to parse.

Each time is its count over the H100's rate (``launch.mesh``); a
collective's over the slowest link its axes cross.  ``dominant`` is the
largest of the three.
"""
from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs.base import ArchConfig, ShapeConfig
from ..models.moe import ep_applies
from ..models.param import leaves
from .mesh import HBM_BW, PEAK_FLOPS, axis_link

# ops that move no bytes; of them, _unsafe_view and lift_fresh return a
# tensor on their input's storage without saying so in their schema
_FREE = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                   "new_empty_strided", "detach", "lift_fresh",
                   "_unsafe_view"})
_ALIASING = frozenset({"_unsafe_view", "lift_fresh"})


def _tensors(x, out: list) -> list:
    """The tensors of nested lists, tuples and dicts, in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _key(x, tensors: list):
    """A hashable key of an op's arguments (a tensor by its metadata),
    appending their tensors to ``tensors`` on the way."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return (tuple(x.shape), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_key(v, tensors) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _key(v, tensors)) for k, v in x.items()))
    if isinstance(x, (torch.device, torch.dtype, torch.layout,
                      torch.memory_format)):
        return str(x)
    return x


def _shape_of(x):
    """A result's metadata, to make it again (:func:`_remake`)."""
    if isinstance(x, torch.Tensor):
        return _Meta(tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return type(x)(_shape_of(v) for v in x)
    return x


def _remake(m):
    if isinstance(m, _Meta):
        return torch.empty_strided(m.shape, m.stride, dtype=m.dtype,
                                   device="meta")
    if isinstance(m, (list, tuple)):
        return type(m)(_remake(v) for v in m)
    return m


@dataclasses.dataclass(frozen=True)
class _Meta:
    shape: tuple
    stride: tuple
    dtype: torch.dtype


class Tracker(TorchDispatchMode):
    """Counts FLOPs, bytes and live bytes of the ops dispatched under it
    (see the module docstring).

    ``arguments``: tensors whose storages are not counted as live;
    ``shard_fraction``: ``{global shape: local bytes / global bytes}`` of
    the parameters.  A ``meta`` op whose inputs' metadata it has seen
    before (function, shapes, strides, dtypes, the other arguments) is
    not run again: its results are made as empty ``meta`` tensors of the
    remembered metadata, which is all a ``meta`` op gives.  Ops that
    alias or write their inputs always run; ``memo`` (a dict) may be
    shared by the traces of one process, since a ``meta`` op's results
    depend on nothing else."""

    def __init__(self, arguments=(), shard_fraction: dict | None = None,
                 memo: dict | None = None):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.shard_fraction = dict(shard_fraction or {})
        self._known: set[int] = set()
        self._live: dict[int, int] = {}
        self._memo = {} if memo is None else memo
        self._funcs: dict = {}
        self._args = _tensors(list(arguments), [])
        for t in self._args:
            self._known.add(id(t.untyped_storage()))

    def new_bytes(self, tree) -> int:
        """Bytes of the tensors of ``tree`` (nested lists, tuples, dicts)
        that alias no argument: the results a step made."""
        args = {id(t.untyped_storage()) for t in self._args}
        return sum(t.numel() * t.element_size() for t in _tensors(tree, [])
                   if id(t.untyped_storage()) not in args)

    def _free(self, key: int) -> None:
        self.live -= self._live.pop(key, 0)
        self._known.discard(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._known:
            return
        nbytes = st.nbytes()
        frac = self.shard_fraction.get(tuple(t.shape))
        if frac is not None and t.numel() * t.element_size() == nbytes:
            nbytes = int(math.ceil(nbytes * frac))
        self._known.add(key)
        self._live[key] = nbytes
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _info(self, func):
        """(aliases or writes an input, moves bytes, FLOP formula) of an
        op, once a function."""
        info = self._funcs.get(func)
        if info is None:
            name = func.__name__.split(".")[0]
            info = self._funcs[func] = (
                name in _ALIASING or any(r.alias_info is not None
                                         for r in func._schema.returns),
                not func.is_view and name not in _FREE,
                flop_registry.get(func._overloadpacket))
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        aliasing, moves, flop = self._info(func)
        inputs: list = []
        key = (func, _key(args, inputs), _key(kwargs, inputs))
        out = None
        if not aliasing and all(t.device.type == "meta" for t in inputs):
            try:
                meta = self._memo.get(key)
            except TypeError:             # an unhashable argument
                meta = key = None
            if meta is not None:
                out = _remake(meta)
            else:
                out = func(*args, **kwargs)
                if key is not None:
                    self._memo[key] = _shape_of(out)
        else:
            out = func(*args, **kwargs)
        if flop is not None:
            self.flops += flop(*args, **kwargs, out_val=out)
        results = _tensors(out, [])
        if moves:
            for t in inputs:
                self.bytes += t.numel() * t.element_size()
            for t in results:
                self.bytes += t.numel() * t.element_size()
        for t in results:
            self._track(t)
        return out


@dataclasses.dataclass
class CostReport:
    flops_dev: float           # per-device, full step
    bytes_dev: float
    coll_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_total: float     # the trace's FLOPs of the whole step
    useful_ratio: float
    trace_s: float
    counts: dict[str, int]


# ---------------------------------------------------------------------------
# Collective bytes from the plan
# ---------------------------------------------------------------------------


def _axes_of(item) -> tuple[str, ...]:
    if item is None:
        return ()
    return (item,) if isinstance(item, str) else tuple(item)


def _group(mesh, axes) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def _ring(kind: str, n: int, nbytes: float) -> float:
    """Bytes a device sends in a ring collective of ``n`` over a tensor of
    ``nbytes`` (the whole tensor, before the split)."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * nbytes
    return (n - 1) / n * nbytes           # all-gather, reduce-scatter


def _contracted(axes: tuple) -> list[int]:
    """The dims a weight leaf contracts: every dim but ``layers`` and
    ``experts`` when its last dim is ``embed`` (an output projection),
    else its ``embed`` dim (an input projection)."""
    body = [i for i, a in enumerate(axes) if a not in ("layers", "experts")]
    if axes[-1] == "embed":
        return body[:-1]
    return [i for i in body if axes[i] == "embed"]


def collective_plan(cfg: ArchConfig, shape: ShapeConfig, mesh, params,
                    annotated, *, n_micro: int, tokens_dev: int
                    ) -> list[dict]:
    """The collectives of one step, per device, from the parameters'
    shardings: a list of ``{"op", "what", "axes", "count", "bytes"}``
    (``bytes``: what one device sends over all ``count`` of them, the
    ring volume: ``2(n−1)/n · X`` for an all-reduce and ``(n−1)/n · X``
    for an all-gather or reduce-scatter of a tensor of ``X`` bytes over
    a group of ``n``).

    ``params``: ``(path, AbstractLeaf)`` pairs; ``annotated``: their
    ``Annotated`` leaves' pairs (the logical axes).  ``tokens_dev``: one microbatch's
    tokens on a device.  ``passes`` below is 3 for a train step (the
    forward, the remat recompute, the backward's transposed collective)
    and 1 for prefill and decode.

    * FSDP all-gathers (train, prefill): each leaf with a ``data``-sharded
      dim is gathered over ``data`` (its model-local size), twice a
      microbatch in training (the forward and the remat recompute), once
      in prefill.
    * Gradient reductions (train), every microbatch (``grad_specs`` pins
      the accumulators to the parameters' shardings): a reduce-scatter
      over ``data`` of each ``data``-sharded leaf's gradient, an
      all-reduce over ``data`` of each other leaf's, and an all-reduce
      over ``pod`` of the ``data``-local gradient, at
      ``grad_accum_dtype``.
    * Partial sums: a weight leaf whose contracted dims (``_contracted``)
      are sharded over mesh axes gives a partial product, all-reduced
      over them: ``tokens_dev`` × its local output features ×
      the activation bytes, a layer of the stack, ``passes`` times a
      microbatch.  Experts sharded over ``model`` are the EP term below.
    * The EP combine of a MoE layer whose experts shard over ``model``:
      with the expert-parallel module (``models.moe.ep_applies``) a psum
      of the ``(tokens, D)`` partial output, N·D; else an all-gather of
      the ``(G, E, C, D)`` expert outputs over ``model``, E·C·D; ``passes``
      times a layer.
    * The logits: an embed-sharded unembedding (decode's 2D TP) gives
      partial logits, all-reduced over the embed dim's axes; vocab-sharded
      ones (over ``model``) need, in training, three all-reduces of a
      float32 a token (the logsumexp's max and sum, the target's logit)
      in the forward and the remat recompute and the backward's ``(tokens,
      D)`` input gradient, and in prefill and decode an all-gather of the
      last tokens' logits.
    """
    kind = shape.kind
    train = kind == "train"
    passes = 3 if train else 1
    act = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    grad_bytes = getattr(torch, cfg.grad_accum_dtype).itemsize
    sizes = mesh.shape
    out: list[dict] = []

    def add(op, what, axes, count, nbytes):
        if count and nbytes:
            out.append({"op": op, "what": what, "axes": tuple(axes),
                        "count": int(count), "bytes": float(nbytes)})

    ann = dict(annotated)
    # the batch the JAX MoE layer sees: a microbatch's rows in training
    ep = cfg.n_experts and ep_applies(
        cfg, mesh, min(cfg.microbatch_seqs, shape.global_batch) if train
        else shape.global_batch)
    for path, leaf in params:
        axes = ann[path].logical_axes
        spec = list(leaf.sharding.spec) + [None] * (len(axes)
                                                   - len(leaf.sharding.spec))
        name = "/".join(str(k) for k in path)
        on_data = any("data" in _axes_of(s) for s in spec)
        model_local = leaf.nbytes / math.prod(
            sizes[a] for s in spec for a in _axes_of(s) if a != "data")
        if kind in ("train", "prefill") and on_data:
            k = 2 * n_micro if train else 1
            add("all-gather", f"fsdp {name}", ("data",), k,
                k * _ring("all-gather", sizes["data"], model_local))
        if train:
            g = model_local / leaf.dtype.itemsize * grad_bytes
            n_d = sizes.get("data", 1)
            if on_data:
                add("reduce-scatter", f"grad {name}", ("data",), n_micro,
                    n_micro * _ring("reduce-scatter", n_d, g))
                g /= n_d
            elif n_d > 1:
                add("all-reduce", f"grad {name}", ("data",), n_micro,
                    n_micro * _ring("all-reduce", n_d, g))
            if sizes.get("pod", 1) > 1:
                add("all-reduce", f"grad {name}", ("pod",), n_micro,
                    n_micro * _ring("all-reduce", sizes["pod"], g))
        if "vocab" in axes or len(axes) < 2:
            continue
        layers = leaf.shape[0] if axes[0] == "layers" else 1
        if "experts" in axes and "model" in _axes_of(
                spec[axes.index("experts")]):
            if axes[-1] == "embed" and path[-1] == "w_down":
                D = cfg.d_model
                if ep:
                    x = tokens_dev * D * act
                    add("all-reduce", f"ep psum {name}", ("model",),
                        layers * passes * n_micro,
                        layers * passes * n_micro
                        * _ring("all-reduce", sizes["model"], x))
                else:
                    from ..models.moe import _capacity
                    S = 1 if kind == "decode" else min(
                        shape.seq_len, cfg.prefill_chunk
                        if kind == "prefill" else shape.seq_len)
                    groups = max(1, tokens_dev // S)
                    x = groups * cfg.n_experts * _capacity(cfg, S) * D * act
                    add("all-gather", f"moe combine {name}", ("model",),
                        layers * passes * n_micro,
                        layers * passes * n_micro
                        * _ring("all-gather", sizes["model"], x))
            continue
        red = tuple(a for i in _contracted(axes) for a in _axes_of(spec[i]))
        if not red:
            continue
        out_dims = [i for i in range(len(axes))
                    if i not in _contracted(axes)
                    and axes[i] not in ("layers", "experts")]
        feat = math.prod(
            leaf.shape[i] // math.prod(sizes[a] for a in _axes_of(spec[i]))
            for i in out_dims)
        x = tokens_dev * feat * act
        add("all-reduce", f"partial sum {name}", red,
            layers * passes * n_micro,
            layers * passes * n_micro * _ring("all-reduce",
                                              _group(mesh, red), x))
    emb = dict(params).get(("embed", "tok"))
    if emb is not None:
        vspec = list(emb.sharding.spec) + [None, None]
        vax, eax = _axes_of(vspec[0]), _axes_of(vspec[1])
        # the unembedding's rows: every token of a microbatch in training
        # (the forward, the remat recompute, the backward), the last
        # token of each sequence in prefill, each slot's in decode
        rows = tokens_dev if kind != "prefill" else max(
            1, tokens_dev // shape.seq_len)
        k = passes * n_micro
        if eax:                      # a partial product over the embed dim
            x = rows * cfg.vocab_size // _group(mesh, vax) * act
            add("all-reduce", "logits partial sum", eax, k,
                k * _ring("all-reduce", _group(mesh, eax), x))
        if vax:
            n = _group(mesh, vax)
            if train:
                add("all-reduce", "logits lse", vax, 3 * 2 * n_micro,
                    3 * 2 * n_micro * _ring("all-reduce", n, rows * 4))
                add("all-reduce", "logits grad", vax, n_micro,
                    n_micro * _ring("all-reduce", n,
                                    rows * cfg.d_model * act))
            else:
                add("all-gather", "last logits", vax, 1,
                    _ring("all-gather", n, rows * cfg.vocab_size * act))
    return out


def collective_time(mesh, plan: list[dict]) -> float:
    """Seconds of the plan's collectives, each over the slowest link its
    axes cross."""
    return sum(c["bytes"] / axis_link(mesh, c["axes"])[1] for c in plan)


def roofline(*, flops_dev: float, bytes_dev: float, coll_dev: float,
             collective_s: float, model_flops: float, flops_total: float,
             trace_s: float, counts: dict) -> CostReport:
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    return CostReport(
        flops_dev=flops_dev, bytes_dev=bytes_dev, coll_dev=coll_dev,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops,
        hlo_flops_total=flops_total,
        useful_ratio=model_flops / max(flops_total, 1.0),
        trace_s=trace_s, counts=counts)


def optimizer_trace(model, ocfg, state, memo: dict | None = None
                    ) -> Tracker:
    """``optimizer.update`` over the model's ``meta`` parameters, gradients
    of ``grad_accum_dtype`` and ``state`` under a :class:`Tracker` (the
    counterpart of the JAX package's ``_optimizer_cost``)."""
    from ..train import optimizer as O
    params = model.param_tree()
    dt = getattr(torch, model.cfg.grad_accum_dtype)
    grads = {}
    for path, p in leaves(params):
        node = grads
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty(p.shape, dtype=dt, device="meta")
    tr = Tracker(arguments=[params, state, grads], memo=memo)
    with tr:
        O.update(ocfg, params, grads, state)
    return tr
