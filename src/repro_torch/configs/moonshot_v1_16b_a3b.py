"""moonshot-v1-16b-a3b [moe] — hf:moonshotai/Moonlight-16B-A3B.

48L d_model=2048 16H (MHA kv=16, head_dim=128) vocab=163840,
fine-grained MoE: 64 experts top-6 with per-expert d_ff=1408.
64 % 16 == 0 ⇒ true expert parallelism on the model axis.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    rope_theta=50_000.0,
    n_experts=64,
    moe_topk=6,
    subquadratic=False,
)
