"""whisper-large-v3 [audio] — arXiv:2212.04356.

Enc-dec, 32+32L d_model=1280 20H (MHA kv=20, head_dim=64) d_ff=5120
vocab=51866. LayerNorm, GELU (ungated) MLP, learned positions. The conv
frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed frame embeddings (B, S_enc, d_model). Decode shapes use the
assigned seq_len for the decoder self-attn cache and 1500 encoder frames
(30 s @ 50 Hz) for cross-attention. Full attention ⇒ long_500k skipped.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    enc_dec=True,
    n_enc_layers=32,
    pos_emb="learned",
    norm="layernorm",
    mlp_gated=False,
    act="gelu",
    frontend="audio_stub",
    enc_len_decode=1500,
    subquadratic=False,
)
