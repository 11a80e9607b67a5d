"""Shared layers: RMSNorm, RoPE, SwiGLU MLP, embeddings.

The counterpart of ``repro/models/layers.py`` for serving: the same
arithmetic (norms and RoPE in float32, cast back to the input type;
matrix products in the working type; float32 logits).  The losses come
with training.
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
