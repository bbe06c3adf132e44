"""Architecture and shape configuration (``--arch <id>`` selectable).

Counterpart of ``repro.configs.base``'s ``ArchConfig`` and
``ShapeConfig`` with the same fields and properties, the assigned shape
set (``SHAPES``) and ``cell_is_runnable``; ``params_dtype`` returns a
``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention
    rope_theta: float = 1e4
    rotary_pct: float = 1.0       # chatglm "RoPE 2d" → 0.5 partial rotary
    qk_norm: bool = False
    attn_pattern: tuple[str, ...] = ("global",)   # cycled: global|local|rglru|mamba
    window: int = 0               # sliding-window size for 'local'
    attn_softcap: float = 0.0     # grok-style logit soft-capping
    # moe
    n_experts: int = 0
    moe_topk: int = 0
    capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    # ssm / rglru
    d_inner: int = 0              # mamba/rglru inner width
    ssm_state: int = 0
    d_conv: int = 4
    dt_rank: int = 0
    # structure
    enc_dec: bool = False
    n_enc_layers: int = 0
    pos_emb: str = "rope"         # rope | learned | none
    frontend: str | None = None   # 'audio_stub' (whisper), None otherwise
    tie_embeddings: bool = True
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    mlp_gated: bool = True
    act: str = "silu"
    # serving schedule
    prefill_chunk: int = 4096     # chunked-prefill width (≤ window if local)
    enc_len_decode: int = 1500    # whisper: encoder frames during decode
    # numerics / schedule policy
    dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"     # grok: bfloat16 (16 GB HBM budget)
    optimizer: str = "adamw"             # grok: adafactor (factored states)
    grad_accum_dtype: str = "float32"
    remat: bool = True
    scan_segments: int = 1        # split the group scan: bounds bwd grad-stack
                                  # buffers to one segment (grok: 4)
    unroll_groups: bool = False   # costing: fully unroll the group scan
    loss_chunks: int = 8
    microbatch_seqs: int = 16     # sequences per grad-accum microbatch
    # long-context capability flag (sub-quadratic attention path exists)
    subquadratic: bool = False
    # ---- hillclimb levers (defaults = paper-faithful baseline) ----
    local_attn_chunked: bool = False   # block-local windowed attention
    moe_impl: str = "gather"           # 'gather' | 'shardmap' (psum combine)
    seq_parallel_residual: bool = True # SP on the scan carry (memory ↓)
    remat_policy: str = "full"         # 'full' | 'dots' (save matmul outs)
    attn_q_chunk: int = 0              # scan q-chunks in non-causal/cross
                                       # attention (bounds score buffers)

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def layer_kind(self, i: int) -> str:
        return self.attn_pattern[i % len(self.attn_pattern)]

    @property
    def n_pattern_groups(self) -> int:
        return self.n_layers // len(self.attn_pattern)

    @property
    def n_remainder_layers(self) -> int:
        return self.n_layers % len(self.attn_pattern)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # 'train' | 'prefill' | 'decode'


def params_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# The assigned shape set (identical for all 10 LM archs).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(cfg: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k only runs for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch — long_500k skipped per assignment"
    return True, ""
