"""State-space / linear-recurrent mixers: Mamba-1 (falcon-mamba) and
RG-LRU (recurrentgemma).

Counterpart of ``repro.models.ssm``, with the same parameter trees,
states and cast points.  Both mixers run a diagonal linear recurrence
``h_t = a_t ⊙ h_{t−1} + b_t``.  The JAX package evaluates it with
``jax.lax.associative_scan`` (an XLA op, no Pallas kernel); here
:func:`linear_recurrence` is a log-depth doubling scan over the sequence
axis in float32: ``ceil(log2 S)`` steps, each one elementwise pass over
``(B, S, ...)``, and no Python loop over tokens.  A decode step is one
fused update ``h = a·h + b``.  The causal depthwise conv keeps a
``(d_conv − 1)``-tap state.  States are ``(conv_state, h)`` tuples, as
the JAX package's; the callers write them into the cache in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .param import param

# ---------------------------------------------------------------------------
# shared: diagonal linear recurrence + causal depthwise conv
# ---------------------------------------------------------------------------


def linear_recurrence(a: torch.Tensor, b: torch.Tensor,
                      h0: torch.Tensor | None = None) -> torch.Tensor:
    """``h_t = a_t ⊙ h_{t−1} + b_t`` along axis 1 (seq); a, b (B,S,...).

    Doubling (Hillis–Steele) scan of the pairs ``(a, b)`` under ``(a1,
    b1) ∘ (a2, b2) = (a1 a2, a2 b1 + b2)``: after the step of stride
    ``d`` each position holds the composition of its last ``2d`` pairs.
    Float sums group differently from XLA's associative scan, so the two
    agree to the reassociation of a product chain."""
    if h0 is not None:
        b = torch.cat([(b[:, :1] + a[:, :1] * h0[:, None]), b[:, 1:]], 1)
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:],
                                               b[:, :-d])], 1)
        if 2 * d < S:                    # the last step needs no a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return b


def causal_conv_specs(width: int, channels: int):
    return {
        "w": param((width, channels), ("state", "ffn")),
        "b": param((channels,), ("ffn",), init="zeros"),
    }


def causal_conv_seq(p, x, state=None):
    """x (B,S,C); state (B,W−1,C) carried taps. Returns (y, new_state)."""
    W = p["w"].shape[0]
    pad = state if state is not None else torch.zeros(
        (x.shape[0], W - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([pad.to(x.dtype), x], dim=1)      # (B, S+W−1, C)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * p["w"][i] for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else pad
    return y + p["b"], new_state


def causal_conv_step(p, x_t, state):
    """x_t (B,1,C); state (B,W−1,C)."""
    taps = torch.cat([state.to(x_t.dtype), x_t], dim=1)   # (B,W,C)
    y = torch.einsum("bwc,wc->bc", taps, p["w"]) + p["b"]
    return y[:, None], taps[:, 1:]


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba-7b): d_inner = 2·d_model, state N, dt_rank = D/16
# ---------------------------------------------------------------------------


def mamba_specs(cfg: ArchConfig):
    D, Di, N, R = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    return {
        "in_proj": param((D, 2 * Di), ("embed", "ffn")),
        "conv": causal_conv_specs(cfg.d_conv, Di),
        "x_proj": param((Di, R + 2 * N), ("ffn", "state")),
        "dt_proj": param((R, Di), ("state", "ffn")),
        "dt_bias": param((Di,), ("ffn",), init="zeros"),
        "A_log": param((Di, N), ("ffn", "state"), init="ones",
                       dtype=torch.float32),
        "D": param((Di,), ("ffn",), init="ones", dtype=torch.float32),
        "out_proj": param((Di, D), ("ffn", "embed")),
    }


def _mamba_core(cfg: ArchConfig, p, xc):
    """Shared projections: xc (B,S,Di) post-conv. Returns (dt, A, Bm, Cm),
    float32."""
    N, R = cfg.ssm_state, cfg.dt_rank
    xdb = xc @ p["x_proj"]
    dt, Bm, Cm = torch.split(xdb, [R, N, N], dim=-1)
    dt = F.softplus((dt @ p["dt_proj"]).float()
                    + p["dt_bias"].float())               # (B,S,Di)
    A = -torch.exp(p["A_log"].float())                    # (Di,N)
    return dt, A, Bm.float(), Cm.float()


def mamba_seq(cfg: ArchConfig, p, x, *, conv_state=None, h0=None):
    """Returns (y, (conv_state, h_last))."""
    xin, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xc, conv_state = causal_conv_seq(p["conv"], xin, conv_state)
    xc = F.silu(xc)
    dt, A, Bm, Cm = _mamba_core(cfg, p, xc)
    xf = xc.float()
    decay = torch.exp(dt[..., None] * A)                  # (B,S,Di,N)
    drive = (dt * xf)[..., None] * Bm[:, :, None, :]
    h = linear_recurrence(decay, drive, h0)               # (B,S,Di,N) f32
    del decay, drive
    y = torch.einsum("bsdn,bsn->bsd", h, Cm) + p["D"] * xf
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], (conv_state, h[:, -1])


def mamba_decode(cfg: ArchConfig, p, x_t, state):
    """x_t (B,1,D); state = (conv_state (B,W−1,Di), h (B,Di,N))."""
    conv_state, h = state
    xin, z = (x_t @ p["in_proj"]).chunk(2, dim=-1)
    xc, conv_state = causal_conv_step(p["conv"], xin, conv_state)
    xc = F.silu(xc)
    dt, A, Bm, Cm = _mamba_core(cfg, p, xc)
    xf = xc[:, 0].float()
    decay = torch.exp(dt[:, 0, :, None] * A)              # (B,Di,N)
    drive = (dt[:, 0] * xf)[..., None] * Bm[:, 0, None, :]
    h = torch.addcmul(drive, decay, h)
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0]) + p["D"] * xf
    y = (y.to(x_t.dtype) * F.silu(z[:, 0]))[:, None]
    return y @ p["out_proj"], (conv_state, h)


def mamba_state_init(cfg: ArchConfig, batch: int, dtype=torch.bfloat16, *,
                     device=None):
    return (torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype,
                        device=device),
            torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                        dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# RG-LRU block (recurrentgemma): gated diagonal LRU + temporal conv
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0  # Griffin's fixed recurrence-sharpness constant


def rglru_specs(cfg: ArchConfig):
    D, Di = cfg.d_model, cfg.d_inner
    return {
        "in_proj": param((D, Di), ("embed", "ffn")),
        "gate_proj": param((D, Di), ("embed", "ffn")),
        "conv": causal_conv_specs(cfg.d_conv, Di),
        "w_input_gate": param((Di, Di), ("ffn", "state")),
        "w_rec_gate": param((Di, Di), ("ffn", "state")),
        "lambda": param((Di,), ("ffn",), init="ones", dtype=torch.float32),
        "out_proj": param((Di, D), ("ffn", "embed")),
    }


def _rglru_gates(p, xc):
    i_t = torch.sigmoid((xc @ p["w_input_gate"]).float())
    r_t = torch.sigmoid((xc @ p["w_rec_gate"]).float())
    a = torch.exp(-_RGLRU_C * r_t * F.softplus(p["lambda"].float()))
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i_t * xc.float())
    return a, b


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def rglru_seq(cfg: ArchConfig, p, x, *, conv_state=None, h0=None):
    """Returns (y, (conv_state, h_last))."""
    u = x @ p["in_proj"]
    z = x @ p["gate_proj"]
    xc, conv_state = causal_conv_seq(p["conv"], u, conv_state)
    a, b = _rglru_gates(p, xc)
    h = linear_recurrence(a, b, h0)                       # (B,S,Di) f32
    y = h.to(x.dtype) * _gelu(z)
    return y @ p["out_proj"], (conv_state, h[:, -1])


def rglru_decode(cfg: ArchConfig, p, x_t, state):
    conv_state, h = state
    u = x_t @ p["in_proj"]
    z = x_t @ p["gate_proj"]
    xc, conv_state = causal_conv_step(p["conv"], u, conv_state)
    a, b = _rglru_gates(p, xc)
    h = torch.addcmul(b[:, 0], a[:, 0], h)
    y = (h.to(x_t.dtype) * _gelu(z[:, 0]))[:, None]
    return y @ p["out_proj"], (conv_state, h)


def rglru_state_init(cfg: ArchConfig, batch: int, dtype=torch.bfloat16, *,
                     device=None):
    return (torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype,
                        device=device),
            torch.zeros((batch, cfg.d_inner), dtype=torch.float32,
                        device=device))
