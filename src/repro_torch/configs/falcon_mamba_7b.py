"""falcon-mamba-7b [ssm] — arXiv:2410.05355.

64 Mamba-1 blocks, d_model=4096 (attention-free), vocab=65024,
d_inner=8192, ssm_state=16, d_conv=4, dt_rank=256.
Attention-free ⇒ trivially sub-quadratic; runs long_500k.

Paper-technique note (DESIGN.md §4): the graph DSL applies only at the
framework level here — there is no attention to shard, the SSM scan is the
temporal mixer.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65024,
    attn_pattern=("mamba",),
    d_inner=8192,
    ssm_state=16,
    d_conv=4,
    dt_rank=256,
    subquadratic=True,
)
