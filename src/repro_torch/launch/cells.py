"""Cell builders: one (arch × shape × mesh) dry-run unit.

Counterpart of ``repro.launch.cells``.  A *cell* bundles the step
callable (closing over a ``meta`` ``LModel``: full width and depth,
nothing allocated), its abstract inputs with resolved shardings
(``models.param.AbstractLeaf``), the donated inputs and the analytic
counts.  The JAX package lowers a cell through XLA (``lower_cell``); the
port has no XLA, and :func:`trace_cell` instead runs the step once on
``meta`` tensors at the per-device batch under ``costing.Tracker``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable

import torch

from ..configs.base import ArchConfig, SHAPES, ShapeConfig, cell_is_runnable
from ..configs.registry import get_config, input_specs
from ..models.model import LModel
from ..models.param import abstract, leaves, specs as param_specs
from ..sharding import partition as ps
from ..train import optimizer as O
from ..train.train_loop import make_train_step
from .costing import Tracker


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    fn: Callable               # the step, on meta tensors
    args: tuple                # abstract inputs (AbstractLeaf trees)
    donate: tuple[int, ...]
    n_micro: int               # train: grad-accum microbatches (else 1)
    model_flops: float         # analytic 6·N_active·D (train) / 2·N_active·D
    params_count: int
    active_params: int
    cfg: ArchConfig
    mesh: Any
    model: LModel              # the step's meta model (full width, depth)
    trace_inputs: Callable     # fn's meta inputs at the per-device batch
    batch_shards: int          # devices the batch splits over
    tokens_dev: int            # one microbatch's tokens on a device


def opt_config(cfg: ArchConfig) -> O.OptConfig:
    return O.OptConfig(state_dtype=cfg.opt_state_dtype,
                       algorithm=cfg.optimizer)


def rules_for(kind: str, overrides: dict | None = None) -> dict:
    base = {"train": ps.TRAIN_RULES, "prefill": ps.PREFILL_RULES,
            "decode": ps.DECODE_RULES}[kind]
    out = dict(base)
    if overrides:
        out.update(overrides)
    return out


# ---------------------------------------------------------------------------
# analytic parameter / FLOP counts
# ---------------------------------------------------------------------------


def param_counts(cfg: ArchConfig) -> tuple[int, int]:
    """(total, active-per-token) non-embedding parameter counts."""
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    per_layer_attn = (D * cfg.n_heads * cfg.head_dim          # wq
                      + 2 * D * cfg.n_kv_heads * cfg.head_dim  # wk, wv
                      + cfg.n_heads * cfg.head_dim * D)        # wo
    n_mats = 3 if cfg.mlp_gated else 2
    per_layer_mlp = n_mats * D * F
    total = active = 0
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind in ("global", "local"):
            total += per_layer_attn
            active += per_layer_attn
        elif kind == "rglru":
            di = cfg.d_inner
            w = 2 * D * di + 2 * di * di + di * D + cfg.d_conv * di
            total += w
            active += w
        elif kind == "mamba":
            di, N, R = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
            w = (D * 2 * di + cfg.d_conv * di + di * (R + 2 * N)
                 + R * di + di * D)
            total += w
            active += w
        if cfg.d_ff > 0 and kind != "mamba":
            if E:
                total += E * per_layer_mlp + D * E
                active += cfg.moe_topk * per_layer_mlp + D * E
            else:
                total += per_layer_mlp
                active += per_layer_mlp
    if cfg.enc_dec:
        enc = cfg.n_enc_layers * (per_layer_attn + per_layer_mlp)
        xattn = cfg.n_layers * per_layer_attn
        total += enc + xattn
        active += enc + xattn
    return total, active


def analytic_model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    _, active = param_counts(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * active * tokens


# ---------------------------------------------------------------------------
# cell builders
# ---------------------------------------------------------------------------


def _max_seq(cfg: ArchConfig, shape: ShapeConfig) -> int:
    return shape.seq_len if cfg.pos_emb == "learned" else 0


def batch_shards(mesh, rules, batch: int) -> int:
    """Devices the batch dim splits over (its resolved mesh axes)."""
    spec = ps.resolve((batch,), ("batch",), mesh, rules)
    return math.prod(mesh.shape[a] for a in ps._axes(spec[0]))


def _meta(shape, dtype):
    return torch.zeros(shape, dtype=dtype, device="meta")


def build_cell(arch: str, shape_name: str | ShapeConfig, mesh, *,
               rule_overrides: dict | None = None,
               cfg_override: ArchConfig | None = None) -> Cell:
    """``shape_name``: a key of ``SHAPES`` or a ``ShapeConfig``."""
    cfg = cfg_override or get_config(arch)
    shape = (shape_name if isinstance(shape_name, ShapeConfig)
             else SHAPES[shape_name])
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        raise ValueError(f"skip: {why}")
    rules = rules_for(shape.kind, rule_overrides)
    B, S = shape.global_batch, shape.seq_len
    shards = batch_shards(mesh, rules, B)
    b_dev = max(1, B // shards)
    n_micro = (max(1, B // cfg.microbatch_seqs) if shape.kind == "train"
               else 1)
    mb_dev = max(1, b_dev // n_micro)
    # the traced model: full width and depth on meta; a train step traces
    # one microbatch of mb_dev sequences
    tcfg = (dataclasses.replace(cfg, microbatch_seqs=mb_dev)
            if shape.kind == "train" else cfg)
    model = LModel(tcfg, max_seq=_max_seq(cfg, shape), device="meta")
    # train/prefill: FSDP (per-layer gathers amortize over the batch);
    # decode: no FSDP — weights get 2D TP via DECODE_RULES' embed→data
    params = model.abstract_params(
        mesh, rules, fsdp=(shape.kind in ("train", "prefill")))
    total, active = param_counts(cfg)
    common = dict(arch=arch, shape=shape, model_flops=analytic_model_flops(
        cfg, shape), params_count=total, active_params=active, model=model,
        batch_shards=shards, cfg=cfg, mesh=mesh)
    bf16 = torch.bfloat16

    if shape.kind == "train":
        ocfg = opt_config(cfg)
        opt_state = O.abstract_state(ocfg, params)
        batch = input_specs(cfg, shape, mesh, rules)
        gspecs = param_specs(model.param_specs(), mesh, rules, fsdp=True)
        step = make_train_step(model, ocfg, grad_specs=gspecs)

        def inputs():
            state = O.init_state(ocfg, model.param_tree())
            b = {k: _meta((mb_dev,) + v.shape[1:], v.dtype)
                 for k, v in batch.items()}
            return (state, b)

        return Cell(fn=step, args=(params, opt_state, batch), donate=(0, 1),
                    n_micro=n_micro, trace_inputs=inputs,
                    tokens_dev=mb_dev * S, **common)

    if shape.kind == "prefill":
        cross = S if cfg.enc_dec else 0
        cache = abstract(model.cache_specs(B, S, bf16, cross_len=cross),
                         mesh, rules, fsdp=False)
        batch = input_specs(cfg, shape, mesh, rules)

        def inputs():
            c = model.init_cache(b_dev, S, bf16, cross_len=cross)
            out = (_meta((b_dev, S), torch.int32),)
            if cfg.enc_dec:
                out += (_meta((b_dev, S, cfg.d_model), bf16),)
            return out + (c,)

        if cfg.enc_dec:
            def fn(tokens, enc_inputs, cache):
                cache = model.build_cross_caches(cache, enc_inputs)
                return model.prefill(tokens, cache, chunk=cfg.prefill_chunk)
            args = (params, batch["tokens"], batch["enc_inputs"], cache)
            donate = (3,)
        else:
            def fn(tokens, cache):
                return model.prefill(tokens, cache, chunk=cfg.prefill_chunk)
            args = (params, batch["tokens"], cache)
            donate = (2,)
        return Cell(fn=fn, args=args, donate=donate, n_micro=1,
                    trace_inputs=inputs, tokens_dev=b_dev * S, **common)

    # decode
    cross = cfg.enc_len_decode if cfg.enc_dec else 0
    cache = abstract(model.cache_specs(B, S, bf16, cross_len=cross),
                     mesh, rules, fsdp=False)
    batch = input_specs(cfg, shape, mesh, rules)

    def fn(tokens_t, cache):
        logits, cache = model.decode_step(tokens_t, cache)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, cache

    def inputs():
        return (_meta((b_dev, 1), torch.int32),
                model.init_cache(b_dev, S, bf16, cross_len=cross))

    return Cell(fn=fn, args=(params, batch["tokens_t"], cache), donate=(2,),
                n_micro=1, trace_inputs=inputs, tokens_dev=b_dev, **common)


@dataclasses.dataclass
class Trace:
    """What :func:`trace_cell` saw: FLOPs and unfused bytes of the traced
    step, the peak of its live non-argument bytes (per device, the
    parameter-shaped buffers at their shard sizes), the bytes of the
    results it made (not aliasing an input), and its seconds."""
    flops: int
    bytes: int
    peak_temp_bytes: int
    new_output_bytes: int
    seconds: float


def shard_fractions(cell: Cell) -> dict:
    """``{global shape: local / global bytes}`` of the parameters (the
    largest where two leaves of one shape differ)."""
    out: dict = {}
    for _, leaf in leaves(cell.args[0]):
        frac = leaf.local_nbytes / max(leaf.nbytes, 1)
        out[leaf.shape] = max(out.get(leaf.shape, 0.0), frac)
    return out


def trace_cell(cell: Cell, memo: dict | None = None) -> Trace:
    """Run the cell's step once on ``meta`` at the per-device batch (one
    microbatch of a train step) under a ``costing.Tracker`` (``memo``:
    its op memo, shareable across cells)."""
    inputs = cell.trace_inputs()
    tr = Tracker(arguments=[cell.model.param_tree(), inputs],
                 shard_fraction=shard_fractions(cell), memo=memo)
    t0 = time.perf_counter()
    with tr:
        out = cell.fn(*inputs)
    seconds = time.perf_counter() - t0
    return Trace(flops=tr.flops, bytes=tr.bytes, peak_temp_bytes=tr.peak,
                 new_output_bytes=tr.new_bytes(out), seconds=seconds)
