"""Mamba-2 (SSD) mixer block.

The counterpart of ``repro/models/ssm.py``.  Structure (arXiv:2405.21060):
in-projections to x (d_inner), z (gate), B/C (per-group state
projections) and dt (per-head step size); a short depthwise causal conv
on x and on B/C (two convs, as the reference splits them); softplus dt;
the SSD scan (:func:`repro_torch.kernels.ssd_scan.ssd_scan`, the
``ssd_fwd`` kernel on the card); gated RMSNorm; out-projection.  Decode
runs the one-token recurrence
:func:`~repro_torch.kernels.ssd_scan.ref.ssd_decode_step` against an
O(1) cache (the conv tails and the float32 state), as the reference
does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_decode_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import ParamSpec
from repro_torch.models.layers import rms_norm

__all__ = ["ssm_specs", "ssm_apply", "ssm_decode", "ssm_cache_shape"]


def ssm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    din = cfg.d_inner
    g, n, h, kc = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    bc = 2 * g * n
    return {
        "w_x": ParamSpec((d, din), ("embed", "conv_dim"), dtype=cfg.pdtype),
        "w_z": ParamSpec((d, din), ("embed", "conv_dim"), dtype=cfg.pdtype),
        "w_bc": ParamSpec((d, bc), ("embed", None), dtype=cfg.pdtype),
        "w_dt": ParamSpec((d, h), ("embed", "ssm_heads"), dtype=cfg.pdtype),
        "conv_x": ParamSpec((kc, din), (None, "conv_dim"), dtype=cfg.pdtype),
        "conv_bc": ParamSpec((kc, bc), (None, None), dtype=cfg.pdtype),
        "A_log": ParamSpec((h,), ("ssm_heads",), init="zeros", dtype=torch.float32),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), init="zeros", dtype=torch.float32),
        "D": ParamSpec((h,), ("ssm_heads",), init="ones", dtype=torch.float32),
        "norm": ParamSpec((din,), ("conv_dim",), init="ones", dtype=torch.float32),
        "out": ParamSpec((din, d), ("conv_dim", "embed"), dtype=cfg.pdtype),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, state=None):
    """x (B, S, C), w (K, C): causal depthwise conv as K shifted
    multiply-adds in x's type, as the reference computes it.  ``state``
    (B, K-1, C) holds the trailing inputs for decode chaining; returns
    (y, new_state)."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, k):
        y = y + xp[:, i : i + s] * w[i].to(x.dtype)
    return y, xp[:, xp.shape[1] - (k - 1):]


def ssm_cache_shape(cfg: ModelConfig, batch: int) -> dict:
    """Decode cache shapes for one layer."""
    return {
        "conv_x": (batch, cfg.ssm_conv - 1, cfg.d_inner),
        "conv_bc": (batch, cfg.ssm_conv - 1, 2 * cfg.ssm_groups * cfg.ssm_state),
        "state": (batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim),
    }


def _projections(p, x):
    return x @ p["w_x"], x @ p["w_z"], x @ p["w_bc"], x @ p["w_dt"]


def _silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU in float32, cast back to the input type."""
    return F.silu(x.float()).to(x.dtype)


def _postprocess(p, y, z, cfg: ModelConfig):
    y = y.reshape(y.shape[0], -1, cfg.d_inner)
    y = y * _silu(z)  # gated
    return rms_norm(y, p["norm"], cfg.norm_eps) @ p["out"]


def _bc(bc: torch.Tensor, cfg: ModelConfig):
    gn = cfg.ssm_groups * cfg.ssm_state
    shape = (*bc.shape[:-1], cfg.ssm_groups, cfg.ssm_state)
    return bc[..., :gn].reshape(shape), bc[..., gn:].reshape(shape)


def ssm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, return_cache: bool = False):
    """Full-sequence SSD mixer over x (B, S, D); with ``return_cache`` also
    the decode cache (conv tails in the working type, float32 state)."""
    b, s, _ = x.shape
    xs_raw, z, bc_raw, dt_raw = _projections(p, x)
    xs, conv_x_tail = _causal_depthwise_conv(xs_raw, p["conv_x"])
    bc, conv_bc_tail = _causal_depthwise_conv(bc_raw, p["conv_bc"])
    xs, bc = _silu(xs), _silu(bc)
    Bm, Cm = _bc(bc, cfg)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(b, s, cfg.ssm_heads, cfg.ssm_headdim)
    y, state = ssd_scan(xh, dt, A, Bm, Cm, p["D"], chunk=min(cfg.ssm_chunk, s))
    out = _postprocess(p, y, z, cfg)
    if not return_cache:
        return out
    return out, {"conv_x": conv_x_tail.to(cfg.dtype), "conv_bc": conv_bc_tail.to(cfg.dtype),
                 "state": state}


def ssm_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig):
    """One-token SSD recurrence on x (B, 1, D); returns ``(out, cache)``
    with the cache's three tensors updated IN PLACE."""
    b = x.shape[0]
    xs, z, bc, dt_raw = _projections(p, x)
    xs, conv_x = _causal_depthwise_conv(xs, p["conv_x"], cache["conv_x"])
    bc, conv_bc = _causal_depthwise_conv(bc, p["conv_bc"], cache["conv_bc"])
    xs, bc = _silu(xs), _silu(bc)
    Bm, Cm = _bc(bc[:, 0], cfg)  # (B, G, N)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])  # (B, H)
    A = -torch.exp(p["A_log"])
    y, state = ssd_decode_step(xs[:, 0].reshape(b, cfg.ssm_heads, cfg.ssm_headdim), dt, A,
                               Bm, Cm, p["D"], cache["state"].float())
    cache["conv_x"].copy_(conv_x)
    cache["conv_bc"].copy_(conv_bc)
    cache["state"].copy_(state)
    return _postprocess(p, y, z, cfg), cache
