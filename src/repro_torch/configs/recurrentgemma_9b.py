"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (Griffin).

38L d_model=4096 16H (MQA kv=1, head_dim=256) d_ff=12288 vocab=256000.
Pattern 2×RG-LRU : 1×local-attention (window 2048); recurrent width =
d_model. Sub-quadratic ⇒ runs long_500k. 38 % 3 = 2 remainder layers run
unrolled after the group scan.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    rope_theta=10_000.0,
    attn_pattern=("rglru", "rglru", "local"),
    window=2048,
    d_inner=4096,
    d_conv=4,
    prefill_chunk=2048,
    subquadratic=True,
)
