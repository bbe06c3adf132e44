"""``--arch <id>`` registry and reduced smoke variants.

Counterpart of ``repro.configs.registry``: the registry, the smoke
variants, the hillclimb profiles (``optimized_config``) and the dry run's
abstract inputs (``input_specs``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.param import AbstractLeaf
from ..sharding.partition import MeshInfo, NamedSharding, resolve
from .base import ArchConfig, ShapeConfig
from . import (chameleon_34b, chatglm3_6b, falcon_mamba_7b, gemma3_4b,
               grok_1_314b, mistral_nemo_12b, moonshot_v1_16b_a3b,
               qwen3_8b, recurrentgemma_9b, whisper_large_v3)

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG for m in (
        mistral_nemo_12b, chatglm3_6b, gemma3_4b, qwen3_8b,
        recurrentgemma_9b, grok_1_314b, moonshot_v1_16b_a3b,
        falcon_mamba_7b, chameleon_34b, whisper_large_v3,
    )
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config: small widths, few experts, tiny vocab —
    preserves the structural features (GQA ratio, layer pattern incl. a
    remainder layer, MoE, SSM, enc-dec)."""
    cfg = get_config(name)
    pat = cfg.attn_pattern
    has_attn = cfg.n_heads > 0
    kv = max(1, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1)) if has_attn else 0
    return dataclasses.replace(
        cfg,
        n_layers=2 * len(pat) + (1 if cfg.n_remainder_layers else 0),
        d_model=64,
        n_heads=4 if has_attn else 0,
        n_kv_heads=kv,
        head_dim=16 if has_attn else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        window=8 if cfg.window else 0,
        n_experts=4 if cfg.n_experts else 0,
        moe_topk=2 if cfg.n_experts else 0,
        capacity_factor=4.0,     # dropless at smoke scale → deterministic

        d_inner=96 if cfg.d_inner else 0,
        ssm_state=4 if cfg.ssm_state else 0,
        dt_rank=8 if cfg.dt_rank else 0,
        n_enc_layers=2 if cfg.enc_dec else 0,
        enc_len_decode=12 if cfg.enc_dec else cfg.enc_len_decode,
        microbatch_seqs=2,
        loss_chunks=2,
        prefill_chunk=8,
    )


# Post-hillclimb optimized profiles (the JAX package's). The registry
# defaults stay paper-faithful baselines; these are the beyond-paper
# winners, selectable via ``optimized_config(name)``.
OPTIMIZED_OVERRIDES: dict[str, dict] = {
    "moonshot-v1-16b-a3b": dict(moe_impl="shardmap",
                                seq_parallel_residual=False,
                                microbatch_seqs=32),
    "gemma3-4b": dict(local_attn_chunked=True, microbatch_seqs=32),
    "mistral-nemo-12b": dict(seq_parallel_residual=False,
                             microbatch_seqs=32),
    "chameleon-34b": dict(seq_parallel_residual=False),
}


def optimized_config(name: str) -> ArchConfig:
    cfg = get_config(name)
    return dataclasses.replace(cfg, **OPTIMIZED_OVERRIDES.get(name, {}))


# ---------------------------------------------------------------------------
# Dry-run input specs: abstract stand-ins for every model input
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape: ShapeConfig, mesh, rules) -> dict:
    """Abstract (never-allocated) inputs of a cell, with batch sharding
    (``models.param.AbstractLeaf``s)."""
    info = MeshInfo.from_mesh(mesh)

    def sds(shp, axes, dtype):
        spec = resolve(shp, axes, info, rules)
        return AbstractLeaf(shp, dtype, NamedSharding(mesh, spec))

    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        out = {
            "tokens": sds((B, S), ("batch", "seq_data"), torch.int32),
            "labels": sds((B, S), ("batch", "seq_data"), torch.int32),
        }
        if cfg.enc_dec:
            # float32, as the pipeline makes them (data.pipeline's
            # synth_batch); the JAX package's input_specs says bfloat16
            out["enc_inputs"] = sds((B, S, cfg.d_model),
                                    ("batch", "seq_data", None),
                                    torch.float32)
        return out
    if shape.kind == "prefill":
        out = {"tokens": sds((B, S), ("batch", "seq_data"), torch.int32)}
        if cfg.enc_dec:
            out["enc_inputs"] = sds((B, S, cfg.d_model),
                                    ("batch", "seq_data", None),
                                    torch.bfloat16)
        return out
    # decode: one new token against a full cache; tokens stay replicated
    # (weight-stationary 2D TP — activations are tiny at decode)
    return {"tokens_t": sds((B, 1), (None, None), torch.int32)}
