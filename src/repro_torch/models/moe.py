"""Mixture-of-Experts with gather-only dispatch and combine.

Counterpart of ``repro.models.moe`` on one device.  Routing runs inside
*routing groups*, the batch rows, and two integer index maps are built
once a routing decision:

    slot→token  (G,E,C):  which token fills expert e's c-th slot (−1 empty)
    token→slot  (G,N,k):  (expert, slot, kept) of each token's k choices

Dispatch and combine are gathers through them; autograd gives the
transpose of each gather (the JAX package writes those transposes as
``custom_vjp``s, which its SPMD partitioner needs; gradients wait for
ROADMAP item 14.5).  Capacity-overflow tokens are dropped (GShard), so
``_capacity`` and the group size ``N`` decide the function: a prefill
chunk's rows are the groups, as in the JAX package.

Every routing step stays on the device (sorts, ``searchsorted``, a small
integer scatter): no ``.item()``, no ``nonzero``, no host-side shape, so
the decode step keeps its one host sync.  Like the reference, every
expert runs on its ``C`` slots, filled or not.  ``apply_moe_shardmap``
(expert-parallel psum) waits for ROADMAP item 14.6; on one device
``apply_moe_auto`` takes the gather path, as the JAX package's does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .param import param


def moe_specs(cfg: ArchConfig):
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": param((D, E), ("embed", "experts"), dtype=torch.float32),
        "w_up": param((E, D, Fd), ("experts", "embed", "expert_ffn")),
        "w_gate": param((E, D, Fd), ("experts", "embed", "expert_ffn")),
        "w_down": param((E, Fd, D), ("experts", "expert_ffn", "embed")),
    }


def _capacity(cfg: ArchConfig, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.moe_topk * cfg.capacity_factor
            / cfg.n_experts) + 1
    if c > 128:
        c = -(-c // 128) * 128
    return min(c, tokens_per_group * min(cfg.moe_topk, cfg.n_experts))


def _routing_maps(idx: torch.Tensor, E: int, C: int):
    """idx: (G,N,k) top-k expert choices. Returns slot_tok (G,E,C) int32,
    the token filling each slot (−1 empty), and the token-major (e_tok,
    rank_tok, keep_tok), each (G,N,k)."""
    G, N, k = idx.shape
    flat_e = idx.reshape(G, N * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)          # (G,Nk)
    sorted_e = torch.gather(flat_e, -1, order)
    tok = order // k
    experts = torch.arange(E, device=idx.device).expand(G, E).contiguous()
    seg_start = torch.searchsorted(sorted_e.contiguous(), experts,
                                   side="left")                  # (G,E)
    ranks = torch.arange(N * k, device=idx.device)[None, :] \
        - torch.gather(seg_start, -1, sorted_e)                  # (G,Nk)
    keep = ranks < C
    safe_rank = torch.where(keep, ranks, 0)
    # a small int scatter builds the slot map: each kept (expert, rank)
    # pair is unique, so the add writes one token a slot
    flat_slot = (sorted_e * C + safe_rank).reshape(G, N * k)
    slot_tok = torch.zeros((G, E * C), dtype=torch.int64,
                           device=idx.device).scatter_add_(
        1, flat_slot, torch.where(keep, tok + 1, 0)) - 1
    # token-major views of (rank, keep): invert the sort
    inv = torch.argsort(order, dim=-1, stable=True)
    rank_tok = torch.gather(safe_rank, -1, inv).reshape(G, N, k)
    keep_tok = torch.gather(keep, -1, inv).reshape(G, N, k)
    return (slot_tok.reshape(G, E, C).to(torch.int32), idx, rank_tok,
            keep_tok)


def dispatch(x, slot_tok):
    """(G,N,D) → (G,E,C,D): buf[g,e,c] = x[g, slot_tok[g,e,c]] (0 if
    empty)."""
    G, E, C = slot_tok.shape
    live = slot_tok >= 0
    safe = torch.where(live, slot_tok, 0).long()
    out = torch.gather(x, 1, safe.reshape(G, E * C, 1).expand(
        -1, -1, x.shape[-1])).reshape(G, E, C, x.shape[-1])
    return torch.where(live[..., None], out, 0)


def undispatch(z, e_tok, rank_tok, keep_tok):
    """(G,E,C,D) → (G,N,k,D): each token's view of its k expert slots."""
    G, E, C, D = z.shape
    N, k = e_tok.shape[1:]
    flat = (e_tok.long() * C + rank_tok.long()).reshape(G, N * k, 1)
    out = torch.gather(z.reshape(G, E * C, D), 1,
                       flat.expand(-1, -1, D)).reshape(G, N, k, D)
    return torch.where(keep_tok[..., None], out, 0)


def _act(cfg: ArchConfig, x):
    # jax.nn.gelu's default is the tanh approximation
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def apply_moe(cfg: ArchConfig, p, x):
    """x: (B, S, D); routing groups = batch rows. Returns (y, aux_loss)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.moe_topk
    C = _capacity(cfg, S)

    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                      # (G,N,E)
    w, idx = torch.topk(probs, k, dim=-1)                      # (G,N,k)
    w = (w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)).to(x.dtype)

    # load-balance aux loss (Switch): E · Σ_e f_e · p̄_e
    me = probs.mean(dim=(0, 1))
    fe = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))
    aux = cfg.moe_aux_coef * E * torch.sum(fe * me)

    slot_tok, e_tok, rank_tok, keep_tok = _routing_maps(idx, E, C)
    buf = dispatch(x, slot_tok)                                 # (G,E,C,D)
    g = torch.einsum("gecd,edf->gecf", buf, p["w_gate"])
    u = torch.einsum("gecd,edf->gecf", buf, p["w_up"])
    out = torch.einsum("gecf,efd->gecd", _act(cfg, g) * u, p["w_down"])
    o_tok = undispatch(out, e_tok, rank_tok, keep_tok)          # (G,N,k,D)
    y = torch.sum(o_tok * w[..., None], dim=2)
    return y, aux


def apply_moe_auto(cfg: ArchConfig, p, x):
    """Module selection: the expert-parallel shard_map implementation
    needs a device mesh (ROADMAP item 14.6); on one device this is the
    gather path whatever ``cfg.moe_impl`` says, as in the JAX package."""
    return apply_moe(cfg, p, x)
