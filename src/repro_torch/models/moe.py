"""Mixture-of-Experts with gather-only dispatch and combine.

Counterpart of ``repro.models.moe``.  Routing runs inside
*routing groups*, the batch rows, and two integer index maps are built
once a routing decision:

    slot→token  (G,E,C):  which token fills expert e's c-th slot (−1 empty)
    token→slot  (G,N,k):  (expert, slot, kept) of each token's k choices

Dispatch and combine are gathers through them; autograd gives the
transpose of each gather (the JAX package writes those transposes as
``custom_vjp``s, which its SPMD partitioner needs).  Capacity-overflow
tokens are dropped (GShard), so ``_capacity`` and the group size ``N``
decide the function: a prefill chunk's rows are the groups, as in the
JAX package.

Every routing step stays on the device (sorts, ``searchsorted``, a small
integer scatter): no ``.item()``, no ``nonzero``, no host-side shape, so
the decode step keeps its one host sync.  Like the reference, every
expert runs on its ``C`` slots, filled or not.

:func:`apply_moe_shardmap` is the JAX package's expert-parallel variant
over the ambient mesh (``sharding.partition.set_mesh``) as a single
controller: each (batch row, ``model`` column) cell of the mesh runs
:func:`_moe_local` on its device, on its rows of the batch and its
``E / n_model`` experts, and each row's partial outputs are summed in
column order by ``core.comm.psum`` on the input's device (an N·D combine
where the gather path moves E·C·D).  :func:`apply_moe_auto` takes it
under the JAX package's conditions (:func:`ep_applies`), else the gather
path; the model code calls ``apply_moe_auto``.  Gradients reach the
parameters by autograd through the cells' copies and the sums.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core import comm as comm_lib
from ..sharding import partition as ps
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


# ---------------------------------------------------------------------------
# Expert parallelism: the combine as a partial sum + psum instead of
# gathering the (G,E,C,D) expert outputs over the model axis. Per layer per
# microbatch the combine volume drops from E·C·D (gather) to N·D (psum).
# Requires E % mesh_model == 0 (true EP); otherwise falls back.
# ---------------------------------------------------------------------------


def _moe_local(cfg: ArchConfig, p, x, n_model: int, col: int):
    """One cell's body: ``x`` (G,N,D) its batch rows, ``p`` its
    ``E / n_model`` experts' weights (``col``'s slice) and the whole
    router.  Returns (its partial output (G,N,D), its routing means
    ``me``, ``fe``), the means taken before the aux loss's product."""
    G, N, D = x.shape
    E, k = cfg.n_experts, cfg.moe_topk
    C = _capacity(cfg, N)
    e_loc = E // n_model

    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    w = (w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)).to(x.dtype)
    me = probs.mean(dim=(0, 1))
    fe = F.one_hot(idx[..., 0], E).float().mean(dim=(0, 1))

    # keep only this column's experts: local ids, everything else to a
    # drop bucket (expert id e_loc), then the single-device maps
    mine = torch.div(idx, e_loc, rounding_mode="floor") == col
    local_idx = torch.where(mine, idx - col * e_loc, e_loc)
    slot_tok, e_tok, rank_tok, keep_tok = _routing_maps(local_idx,
                                                        e_loc + 1, C)
    slot_tok = slot_tok[:, :e_loc]                # drop the overflow bucket
    keep_tok = keep_tok & (e_tok < e_loc)
    e_tok = torch.where(e_tok < e_loc, e_tok, 0)

    buf = dispatch(x, slot_tok)                                 # (G,e,C,D)
    g = torch.einsum("gecd,edf->gecf", buf, p["w_gate"])
    u = torch.einsum("gecd,edf->gecf", buf, p["w_up"])
    out = torch.einsum("gecf,efd->gecd", _act(cfg, g) * u, p["w_down"])
    o_tok = undispatch(out, e_tok, rank_tok, keep_tok)          # (G,N,k,D)
    return torch.sum(o_tok * w[..., None], dim=2), me, fe


def _batch_axes(mesh) -> list[str]:
    return [a for a in ("pod", "data") if a in mesh.axis_names]


def ep_applies(cfg: ArchConfig, mesh, batch: int) -> bool:
    """Whether ``apply_moe_auto`` takes the expert-parallel path for a
    batch of ``batch`` rows on ``mesh``: the JAX package's conditions
    (``moe_impl == "shardmap"``, a ``model`` axis over 1 that divides
    the experts, batch rows that split over the batch axes)."""
    if cfg.moe_impl != "shardmap" or mesh is None or not mesh.axis_names:
        return False
    sizes = mesh.shape
    n_model = sizes.get("model", 1)
    rows = math.prod(sizes[a] for a in _batch_axes(mesh))
    return (n_model > 1 and cfg.n_experts % n_model == 0
            and batch % max(rows, 1) == 0)


def apply_moe_shardmap(cfg: ArchConfig, p, x):
    """The expert-parallel MoE over the ambient mesh (module docstring).
    Returns (y, aux_loss) on ``x``'s device; the ambient ``CommManager``,
    if any, records the psum (one exchange a call: every cell's partial
    output)."""
    mesh = ps.get_mesh()
    sizes = mesh.shape
    n_model = sizes.get("model", 1)
    baxes = _batch_axes(mesh)
    if set(mesh.axis_names) - set(baxes) - {"model"}:
        raise ValueError(f"mesh axes {mesh.axis_names}: the expert-parallel "
                         "MoE takes batch axes and 'model' only")
    n_rows = math.prod(sizes[a] for a in baxes)
    order = [mesh.axis_names.index(a) for a in baxes]
    order += [mesh.axis_names.index("model")] if "model" in sizes else []
    devs = np.transpose(mesh.devices, order).reshape(n_rows, n_model)
    E = cfg.n_experts
    e_loc = E // n_model
    B = x.shape[0]
    rows = B // n_rows
    home = x.device
    ys, mes, fes = [], [], []
    for r in range(n_rows):
        xr = x[r * rows:(r + 1) * rows]
        parts = []
        for c in range(n_model):
            dev = devs[r, c]
            pc = {"router": p["router"].to(dev)}
            for name in ("w_up", "w_gate", "w_down"):
                pc[name] = p[name][c * e_loc:(c + 1) * e_loc].to(dev)
            y_part, me, fe = _moe_local(cfg, pc, xr.to(dev), n_model, c)
            parts.append(y_part)
            mes.append(me)
            fes.append(fe)
        ys.append(comm_lib.psum(parts, device=home))       # N·D combine
    # the aux loss from global means (a per-cell aux averaged afterwards
    # is a different loss)
    me = comm_lib.psum(mes, device=home) / len(mes)
    fe = comm_lib.psum(fes, device=home) / len(fes)
    aux = cfg.moe_aux_coef * E * torch.sum(fe * me)
    comm = ps.get_comm()
    if comm is not None:
        comm.stats.record_collective(
            parts[0].numel() * parts[0].element_size(), 1,
            tables=n_rows * n_model)
    return torch.cat(ys, dim=0), aux


def apply_moe_auto(cfg: ArchConfig, p, x):
    """Module selection (the paper's translator idea): the expert-parallel
    psum when the ambient mesh allows it (:func:`ep_applies`), else the
    gather path (always on one device)."""
    if ep_applies(cfg, ps.get_mesh(), x.shape[0]):
        return apply_moe_shardmap(cfg, p, x)
    return apply_moe(cfg, p, x)
