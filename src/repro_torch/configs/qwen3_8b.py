"""qwen3-8b [dense] — hf:Qwen/Qwen3-8B.

36L d_model=4096 32H (GQA kv=8, head_dim=128) d_ff=12288 vocab=151936,
qk-norm on.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    rope_theta=1_000_000.0,
    qk_norm=True,
    subquadratic=False,
)
