"""chatglm3-6b [dense] — arXiv:2406.12793.

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
"RoPE 2d" ⇒ partial rotary over half the head dim (rotary_pct=0.5).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rope_theta=10_000.0,
    rotary_pct=0.5,
    subquadratic=False,
)
