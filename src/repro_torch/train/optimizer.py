"""Optimizers: AdamW (dtype-configurable states) and Adafactor.

Counterpart of ``repro.train.optimizer`` as plain functions over a dict
tree keyed as the JAX params (``LModel.param_tree()``: ``blocks/pos{j}``
leaves stacked over groups), not ``torch.optim``.  Updates compute in
float32 and store the states in ``state_dtype``; gradients are clipped by
their global norm and scaled by ``grad_scale`` (the train step's ``1/M``
folds in there).  A leaf over 2^24 elements with a stacked first axis
updates slice by slice over it, so that no float32 copy of the whole leaf
exists (Adafactor's update clipping is then per slice, as in the JAX
package).

The JAX functions return new trees (its train step donates the old
ones); these update ``params`` and the state's tensors in place, its
``step`` too, and return the same trees with the metrics.  Every scalar
stays a 0-d tensor on the parameters' device: an update reads nothing
back to the host.  :func:`abstract_state` gives the dry run's
never-allocated state (``models.param.AbstractLeaf``s).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..models.param import AbstractLeaf, leaves, map_tree
from ..sharding.partition import NamedSharding, PartitionSpec

CHUNK_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"
    algorithm: str = "adamw"      # 'adamw' | 'adafactor'


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine decay to
    ``min_lr_ratio · peak_lr`` at ``decay_steps`` (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.peak_lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5
                         * (1 + torch.cos(math.pi * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _factored_shapes(shape: tuple[int, ...]):
    """Adafactor row/col factor shapes for ndim≥2 leaves (last two dims)."""
    return shape[:-1], shape[:-2] + shape[-1:]


def _device(params: Any) -> torch.device:
    return next(t for _, t in leaves(params)).device


def init_state(cfg: OptConfig, params: Any) -> dict:
    dev = _device(params)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.algorithm == "adafactor":
        def vr(p):
            shape = _factored_shapes(p.shape)[0] if p.ndim >= 2 else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vc(p):
            shape = _factored_shapes(p.shape)[1] if p.ndim >= 2 else ()
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return {"vr": map_tree(vr, params), "vc": map_tree(vc, params),
                "step": step}
    dt = getattr(torch, cfg.state_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": step}


def abstract_state(cfg: OptConfig, abstract_params: Any) -> dict:
    """The state as ``AbstractLeaf``s matching the parameters'
    shardings: AdamW's ``m``/``v`` in ``state_dtype`` follow them;
    Adafactor's factored states (tiny) and the step are replicated."""
    mesh = next(a for _, a in leaves(abstract_params)).sharding.mesh
    rep = NamedSharding(mesh, PartitionSpec())
    step = AbstractLeaf((), torch.int32, rep)
    if cfg.algorithm == "adafactor":
        def vr(p):
            return AbstractLeaf(_factored_shapes(p.shape)[0]
                                if len(p.shape) >= 2 else p.shape,
                                torch.float32, rep)

        def vc(p):
            return AbstractLeaf(_factored_shapes(p.shape)[1]
                                if len(p.shape) >= 2 else (),
                                torch.float32, rep)

        return {"vr": map_tree(vr, abstract_params),
                "vc": map_tree(vc, abstract_params), "step": step}
    dt = getattr(torch, cfg.state_dtype)

    def like(p):
        return AbstractLeaf(p.shape, dt, p.sharding)

    return {"m": map_tree(like, abstract_params),
            "v": map_tree(like, abstract_params), "step": step}


def _big(p: torch.Tensor) -> bool:
    return p.ndim >= 3 and p.shape[0] > 1 and p.numel() > CHUNK_ELEMS


def _sumsq(x: torch.Tensor) -> torch.Tensor:
    """Σx² in float32 without a full-leaf float32 copy: big stacked leaves
    reduce slice by slice."""
    if _big(x):
        acc = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(x.shape[0]):
            acc = acc + torch.sum(torch.square(x[i].float()))
        return acc
    return torch.sum(torch.square(x.float()))


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(_sumsq(x) for _, x in leaves(tree)))


def _clip_scale(cfg: OptConfig, grads, grad_scale: float):
    gnorm = global_norm(grads) * grad_scale
    scale = grad_scale * torch.clamp(
        cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), max=1.0)
    return gnorm, scale


def _each_slice(fn, p, *rest):
    """``fn`` on the whole leaf, or slice by slice over a big stacked
    leaf's first axis."""
    if _big(p):
        for i in range(p.shape[0]):
            fn(p[i], *(t[i] for t in rest))
    else:
        fn(p, *rest)


def _zip(params, *trees):
    others = [dict(leaves(t)) for t in trees]
    for path, p in leaves(params):
        yield (p,) + tuple(o[path] for o in others)


@torch.no_grad()
def adafactor_update(cfg: OptConfig, params: Any, grads: Any, state: dict,
                     grad_scale: float = 1.0) -> tuple[Any, dict, dict]:
    """Adafactor (β1=0, factored second moment): state O(rows+cols) per
    matrix instead of 2× the parameters."""
    state["step"].add_(1)
    step = state["step"].to(torch.float32)
    gnorm, scale = _clip_scale(cfg, grads, grad_scale)
    lr = lr_at(cfg, state["step"])
    decay = 1.0 - step ** -0.8                     # Adafactor β2 schedule
    eps = 1e-30

    def upd(p, g, vr, vc):
        g = g.float() * scale
        g2 = g * g + eps
        if p.ndim >= 2:
            nvr = decay * vr + (1 - decay) * torch.mean(g2, dim=-1)
            nvc = decay * vc + (1 - decay) * torch.mean(g2, dim=-2)
            mean_r = torch.mean(nvr, dim=-1, keepdim=True)
            rhat = (nvr / torch.clamp_min(mean_r, eps))[..., None]
            chat = nvc[..., None, :]
            u = g * torch.rsqrt(torch.clamp_min(rhat * chat, eps))
        else:
            nvr = decay * vr + (1 - decay) * g2
            nvc = vc
            u = g * torch.rsqrt(torch.clamp_min(nvr, eps))
        # update clipping (RMS ≤ 1) per Adafactor
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp_min(rms, 1.0)
        p32 = p.float()
        p.copy_(p32 - lr * (u + cfg.weight_decay * p32))
        vr.copy_(nvr)
        vc.copy_(nvc)

    for p, g, vr, vc in _zip(params, grads, state["vr"], state["vc"]):
        _each_slice(upd, p, g, vr, vc)
    return params, state, {"lr": lr, "grad_norm": gnorm}


@torch.no_grad()
def adamw_update(cfg: OptConfig, params: Any, grads: Any, state: dict,
                 grad_scale: float = 1.0) -> tuple[Any, dict, dict]:
    """Returns (params, state, metrics), the first two updated in place."""
    state["step"].add_(1)
    step = state["step"].to(torch.float32)
    gnorm, scale = _clip_scale(cfg, grads, grad_scale)
    lr = lr_at(cfg, state["step"])
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step)
    bc2 = 1 - torch.pow(b2, step)

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        mh = m32 / bc1
        vh = v32 / bc2
        p32 = p.float()
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
        m.copy_(m32)
        v.copy_(v32)

    for p, g, m, v in _zip(params, grads, state["m"], state["v"]):
        _each_slice(upd, p, g, m, v)
    return params, state, {"lr": lr, "grad_norm": gnorm}


def update(cfg: OptConfig, params: Any, grads: Any, state: dict,
           grad_scale: float = 1.0):
    if cfg.algorithm == "adafactor":
        return adafactor_update(cfg, params, grads, state, grad_scale)
    return adamw_update(cfg, params, grads, state, grad_scale)
