"""gemma3-4b [dense] — hf:google/gemma-3-*-pt family.

34L d_model=2560 8H (GQA kv=4, head_dim=256) d_ff=10240 vocab=262144.
5:1 local:global sliding-window pattern (window=1024), 128k context.
Sub-quadratic (windowed) ⇒ runs long_500k. Prefill chunk clamped to the
window so ring writes stay unique.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    rope_theta=1_000_000.0,
    qk_norm=True,
    attn_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    prefill_chunk=1024,
    subquadratic=True,
)
