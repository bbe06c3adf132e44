"""grok-1-314b [moe] — hf:xai-org/grok-1.

64L d_model=6144 48H (GQA kv=8, head_dim=128) vocab=131072,
MoE 8 experts top-2 with per-expert d_ff=32768; attention logit
soft-capping 30. Full attention ⇒ long_500k skipped.

Memory policy (16 GB HBM/chip at 256 chips): bf16 optimizer states and
bf16 gradient accumulation (DESIGN.md §5 budget).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    rope_theta=10_000.0,
    attn_softcap=30.0,
    n_experts=8,
    moe_topk=2,
    opt_state_dtype="bfloat16",
    optimizer="adafactor",
    grad_accum_dtype="bfloat16",
    subquadratic=False,
)
