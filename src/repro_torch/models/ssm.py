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
from repro_torch.parallel.sharding import (
    ShardingCtx,
    assign,
    is_dtensor,
    local_call,
    replicate_like,
)

_NO_MESH = ShardingCtx.none()

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
        pad = replicate_like(
            torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device), x)
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


def _projections(p, x, ctx: ShardingCtx):
    return (x @ ctx.weight(p["w_x"], ("embed", "conv_dim")),
            x @ ctx.weight(p["w_z"], ("embed", "conv_dim")),
            x @ ctx.weight(p["w_bc"], ("embed", None)),
            x @ ctx.weight(p["w_dt"], ("embed", "ssm_heads")))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU in float32, cast back to the input type."""
    return F.silu(x.float()).to(x.dtype)


def _postprocess(p, y, z, cfg: ModelConfig, ctx: ShardingCtx):
    y = y.reshape(y.shape[0], -1, cfg.d_inner)
    y = y * _silu(z)  # gated
    return rms_norm(y, p["norm"], cfg.norm_eps) @ ctx.weight(p["out"], ("conv_dim", "embed"))


def _bc(bc: torch.Tensor, cfg: ModelConfig):
    gn = cfg.ssm_groups * cfg.ssm_state
    shape = (*bc.shape[:-1], cfg.ssm_groups, cfg.ssm_state)
    return bc[..., :gn].reshape(shape), bc[..., gn:].reshape(shape)


def ssm_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, return_cache: bool = False,
              ctx: ShardingCtx = _NO_MESH):
    """Full-sequence SSD mixer over x (B, S, D); with ``return_cache`` also
    the decode cache (conv tails in the working type, float32 state)."""
    b, s, _ = x.shape
    xs_raw, z, bc_raw, dt_raw = _projections(p, x, ctx)
    xs_raw = ctx.constrain(xs_raw, ("batch", "seq", "act_mlp"))
    z = ctx.constrain(z, ("batch", "seq", "act_mlp"))
    bc_raw = ctx.constrain(bc_raw, ("batch", "seq", None))
    dt_raw = ctx.constrain(dt_raw, ("batch", "seq", "act_heads"))
    xs, conv_x_tail = _causal_depthwise_conv(xs_raw, p["conv_x"])
    bc, conv_bc_tail = _causal_depthwise_conv(bc_raw, p["conv_bc"])
    xs, bc = _silu(xs), _silu(bc)
    Bm, Cm = _bc(bc, cfg)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(b, s, cfg.ssm_heads, cfg.ssm_headdim)
    y, state = ssd_scan(xh, dt, A, Bm, Cm, p["D"], chunk=min(cfg.ssm_chunk, s))
    out = _postprocess(p, y, z, cfg, ctx)
    if not return_cache:
        return out
    return out, {"conv_x": conv_x_tail.to(cfg.dtype), "conv_bc": conv_bc_tail.to(cfg.dtype),
                 "state": state}


def _decode_step(x, dt, A, Bm, Cm, D, state):
    """:func:`ssd_decode_step`; under a mesh on each rank's shard, placed
    as the state is (its batch and head shards kept)."""
    if not is_dtensor(state):
        return ssd_decode_step(x, dt, A, Bm, Cm, D, state)
    from torch.distributed.tensor import Replicate, Shard

    sp = tuple(a if a in (Shard(0), Shard(1)) else Replicate() for a in state.placements)
    hp = tuple(Shard(0) if a == Shard(1) else Replicate() for a in sp)  # (H,) vectors
    bp = tuple(Shard(0) if a == Shard(0) else Replicate() for a in sp)  # (B, G, N)
    return local_call(ssd_decode_step, (x, dt, A, Bm, Cm, D, state),
                      (sp, sp, hp, bp, bp, hp, sp), (sp, sp), state.device_mesh)


def ssm_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig,
               ctx: ShardingCtx = _NO_MESH):
    """One-token SSD recurrence on x (B, 1, D); returns ``(out, cache)``
    with the cache's three tensors updated IN PLACE."""
    b = x.shape[0]
    xs, z, bc, dt_raw = _projections(p, x, ctx)
    xs, conv_x = _causal_depthwise_conv(xs, p["conv_x"], cache["conv_x"])
    bc, conv_bc = _causal_depthwise_conv(bc, p["conv_bc"], cache["conv_bc"])
    xs, bc = _silu(xs), _silu(bc)
    Bm, Cm = _bc(bc[:, 0], cfg)  # (B, G, N)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])  # (B, H)
    A = -torch.exp(p["A_log"])
    y, state = _decode_step(xs[:, 0].reshape(b, cfg.ssm_heads, cfg.ssm_headdim), dt, A,
                            Bm, Cm, p["D"], cache["state"].float())
    for name, t in (("conv_x", conv_x), ("conv_bc", conv_bc), ("state", state)):
        assign(cache[name], t)
    return _postprocess(p, y, z, cfg, ctx), cache
