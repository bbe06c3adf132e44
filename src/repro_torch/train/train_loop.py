"""Training step: microbatch gradient accumulation + the optimizer.

Counterpart of ``repro.train.train_loop``.  ``n_micro = global_batch /
microbatch_seqs`` microbatches run one after another through the model;
each one's gradients (in the parameters' dtype, as ``jax.grad`` gives
them) are added into accumulators of ``cfg.grad_accum_dtype``, and ``1/M``
goes to the optimizer as its ``grad_scale`` (a tree-wide divide would
make a full-leaf temporary of every accumulator).  The parameters are the
model's own (``LModel.param_tree()``), so the step updates the model in
place.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..models.model import LModel
from ..models.param import leaves, unflatten
from . import optimizer as O


def microbatches(cfg: ArchConfig, batch: dict) -> tuple[dict, int]:
    """Reshape (B, ...) leaves to (M, mb, ...)."""
    B = batch["tokens"].shape[0]
    mb = min(cfg.microbatch_seqs, B)
    while B % mb:
        mb -= 1
    M = B // mb
    return {k: v.reshape(M, mb, *v.shape[1:]) for k, v in batch.items()}, M


def make_train_step(model: LModel, opt_cfg: O.OptConfig, grad_specs=None):
    """``train_step(opt_state, batch) -> (opt_state, metrics)``: one
    optimizer step of ``model`` on ``batch`` (a dict of tensors on the
    model's device), its parameters and ``opt_state`` updated in place;
    ``metrics`` holds 0-d tensors ``loss`` (the microbatches' mean),
    ``grad_norm`` and ``lr``.  Turns on gradients for every parameter of
    ``model`` (serving, under ``torch.no_grad``, is not affected).

    ``grad_specs`` (a PartitionSpec tree matching the parameters) is the
    JAX package's pin of the gradient accumulators to the parameters'
    shardings.  The step runs on one device, where the pin changes no
    value (as ``with_sharding_constraint`` changes none); it is kept on
    the step as ``train_step.grad_specs`` for the planner
    (``launch/costing.py`` counts the accumulators at the parameters'
    shard sizes and reduce-scatters them every microbatch)."""
    cfg = model.cfg
    accum_dt = getattr(torch, cfg.grad_accum_dtype)
    params = model.param_tree()
    paths, tensors = zip(*leaves(params))
    for t in tensors:
        t.requires_grad_(True)

    def train_step(opt_state: dict, batch: dict):
        mbs, M = microbatches(cfg, batch)
        gacc = [torch.zeros(t.shape, dtype=accum_dt, device=t.device)
                for t in tensors]
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        for i in range(M):
            with torch.enable_grad():
                loss = model.loss_fn({k: v[i] for k, v in mbs.items()})
                grads = torch.autograd.grad(loss, tensors, allow_unused=True)
            for a, g in zip(gacc, grads):
                if g is not None:          # an unused leaf's gradient is 0
                    a.add_(g.to(accum_dt))
            loss_sum = loss_sum + loss.detach()
            del grads, loss
        grad_tree = unflatten(zip(paths, gacc))
        _, opt_state, metrics = O.update(opt_cfg, params, grad_tree,
                                         opt_state, grad_scale=1.0 / M)
        return opt_state, dict(metrics, loss=loss_sum / M)

    train_step.grad_specs = grad_specs
    return train_step


def make_eval_step(model: LModel):
    @torch.no_grad()
    def eval_step(batch: dict) -> torch.Tensor:
        return model.loss_fn(batch)
    return eval_step
