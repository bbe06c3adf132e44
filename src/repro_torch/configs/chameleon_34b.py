"""chameleon-34b [vlm] — arXiv:2405.09818.

48L d_model=8192 64H (GQA kv=8, head_dim=128) d_ff=22016 vocab=65536.
Early-fusion VLM: VQ image tokens are ordinary vocabulary ids, so the
backbone is a dense decoder (qk-norm per the paper); the image tokenizer
frontend is a stub per the assignment.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    rope_theta=10_000.0,
    qk_norm=True,
    prefill_chunk=2048,   # halves the (B,H,chunk,S) score working set
    subquadratic=False,
)
