"""Shared layers: RMSNorm, RoPE, SwiGLU MLP, embeddings, cross-entropy.

The counterpart of ``repro/models/layers.py``: the same arithmetic (norms
and RoPE in float32, cast back to the input type; matrix products in the
working type; float32 logits and losses).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.init import ParamSpec

__all__ = [
    "rms_norm",
    "rope",
    "mlp_specs",
    "mlp_apply",
    "embed_specs",
    "embed_tokens",
    "unembed",
    "cross_entropy",
    "chunked_cross_entropy",
]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, cast back to the input dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on the last dim; x (..., S, H, D), positions (..., S)."""
    half = x.shape[-1] // 2
    # a Python-number base: a tensor made from theta on the card would be a
    # host-to-device copy, which waits for the stream on every call
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wg": ParamSpec((d, f), ("embed", "mlp"), dtype=cfg.pdtype),
        "wu": ParamSpec((d, f), ("embed", "mlp"), dtype=cfg.pdtype),
        "wd": ParamSpec((f, d), ("mlp", "embed"), dtype=cfg.pdtype),
    }


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h_g = x @ p["wg"]
    h_u = x @ p["wu"]
    act = (F.silu(h_g.float()) * h_u.float()).to(x.dtype)
    return act @ p["wd"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_specs(cfg: ModelConfig) -> dict:
    v, d = cfg.padded_vocab, cfg.d_model
    specs = {
        "tok": ParamSpec((v, d), ("vocab", "embed"), scale=0.02, init="normal",
                         dtype=cfg.pdtype),
        "final_norm": ParamSpec((d,), (None,), init="ones", dtype=torch.float32),
    }
    if not cfg.tie_embeddings:
        specs["head"] = ParamSpec((d, v), ("embed", "vocab"), dtype=cfg.pdtype)
    return specs


def embed_tokens(p: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return p["tok"][tokens].to(cfg.dtype)


def unembed(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits over the padded vocabulary, in float32 (as the reference's
    ``layers.py:91``); the product itself runs in the working type."""
    w = p["head"] if "head" in p else p["tok"].T
    return (x @ w).float()


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in f32; labels < 0 or ~valid are masked."""
    if valid is None:
        valid = labels >= 0
    lab = labels.clamp(min=0).long()
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, lab[..., None])[..., 0]
    nll = (lse - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)


def chunked_cross_entropy(
    x: torch.Tensor,  # (B, S, D) final hidden states
    w: torch.Tensor,  # (D, V) unembedding
    labels: torch.Tensor,  # (B, S)
    valid: torch.Tensor | None,
    chunk: int,
) -> torch.Tensor:
    """Cross-entropy over the vocabulary in chunks of ``chunk``: a running
    logsumexp and the gold logit gathered chunk by chunk, as the
    reference's ``lax.scan`` (a Python loop here)."""
    if valid is None:
        valid = labels >= 0
    b, s, _ = x.shape
    v = w.shape[-1]
    if v % chunk:
        raise ValueError(f"vocab {v} not divisible by chunk {chunk}")
    lab = labels.clamp(min=0).long()
    m = torch.full((b, s), -torch.inf, dtype=torch.float32, device=x.device)
    l = torch.zeros((b, s), dtype=torch.float32, device=x.device)
    gold = torch.zeros((b, s), dtype=torch.float32, device=x.device)
    for c0 in range(0, v, chunk):
        lg = (x @ w[:, c0 : c0 + chunk]).float()  # (B, S, chunk)
        m_new = torch.maximum(m, lg.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(lg - m_new[..., None]).sum(dim=-1)
        in_chunk = (lab >= c0) & (lab < c0 + chunk)
        local = torch.gather(lg, -1, (lab - c0).clamp(0, chunk - 1)[..., None])[..., 0]
        gold = torch.where(in_chunk, local, gold)
        m = m_new
    nll = (m + torch.log(l.clamp(min=1e-30)) - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)
