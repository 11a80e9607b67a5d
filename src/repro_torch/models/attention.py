"""GQA attention: full-sequence self attention (prefill, training; causal
or bidirectional), cross attention against a memory, and one-token
decode.

The counterpart of ``repro/models/attention.py`` on one device.
Full-sequence and cross attention go through the ``flash_fwd`` kernel,
and in training its backward through ``flash_dkv`` and ``flash_dq``
(:func:`repro_torch.kernels.flash_attention.flash_attention`); so does
cross attention in a decode step, whose one query row attends over the
whole memory, as the reference's does.  Self-attention decode attends
one new token over the KV cache with the plain
:func:`~repro_torch.kernels.flash_attention.ref.ref_attention`, as the
reference's ``attn_decode`` does.  The sequence-parallel decode comes
with the sharding slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import ref_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import ParamSpec
from repro_torch.models.layers import rms_norm, rope

__all__ = ["attn_specs", "cross_attn_specs", "attn_apply", "attn_decode", "cross_attn_apply",
           "memory_kv"]


def attn_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    """The projections (and the qk-norm scales); with ``cross`` also the
    scalar float32 ``gate`` of a gated cross-attention block, 0 at init."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    specs = {
        "wq": ParamSpec((d, hq, hd), ("embed", "q_heads", "head_dim"), dtype=cfg.pdtype),
        "wk": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim"), dtype=cfg.pdtype),
        "wv": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim"), dtype=cfg.pdtype),
        "wo": ParamSpec((hq, hd, d), ("q_heads", "head_dim", "embed"), dtype=cfg.pdtype),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), (None,), init="ones", dtype=torch.float32)
        specs["k_norm"] = ParamSpec((hd,), (None,), init="ones", dtype=torch.float32)
    if cross:
        specs["gate"] = ParamSpec((), (), init="zeros", dtype=torch.float32)
    return specs


def cross_attn_specs(cfg: ModelConfig) -> dict:
    return attn_specs(cfg, cross=True)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _project_q(p, x, cfg: ModelConfig, positions):
    """q (B, S, Hq, hd); RoPE at ``positions`` unless they are None."""
    q = _heads(x, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return q if positions is None else rope(q, positions, cfg.rope_theta)


def _project_kv(p, x, cfg: ModelConfig, positions):
    """(k, v) (B, S, Hkv, hd); RoPE on k at ``positions`` unless None."""
    k = _heads(x, p["wk"])
    v = _heads(x, p["wv"])
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return (k if positions is None else rope(k, positions, cfg.rope_theta)), v


def _out_proj(p, o):
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, k, d = p["wo"].shape
    return o.reshape(*o.shape[:-2], h * k) @ p["wo"].reshape(h * k, d)


def attn_apply(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    positions: torch.Tensor,  # (B, S)
    *,
    causal: bool = True,
    window: int | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence self attention (prefill, training; ``causal=False``
    for an encoder); returns ``(out, (k, v))``, the projected keys and
    values being what the serving cache holds."""
    q = _project_q(p, x, cfg, positions)
    k, v = _project_kv(p, x, cfg, positions)
    o = flash_attention(q, k, v, causal=causal, window=window)
    return _out_proj(p, o), (k, v)


def cross_attn_apply(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    memory_kv: tuple[torch.Tensor, torch.Tensor],  # each (B, S_mem, Hkv, hd)
    cfg: ModelConfig,
    *,
    gated: bool = False,
) -> torch.Tensor:
    """Cross attention against a memory's precomputed K/V: no RoPE, no
    mask.  With ``gated`` (Llama-3.2-Vision) the output is scaled by
    ``tanh(gate)`` in the output's type; the gate is 0 at init, so an
    initialised model's cross blocks add nothing."""
    q = _project_q(p, x, cfg, positions=None)
    k, v = memory_kv
    out = _out_proj(p, flash_attention(q, k, v, causal=False))
    if gated:
        out = torch.tanh(p["gate"]).to(out.dtype) * out
    return out


def memory_kv(p: dict, memory: torch.Tensor, cfg: ModelConfig):
    """(k, v) of a memory (B, S_mem, D) for :func:`cross_attn_apply`,
    projected once a sequence: no RoPE."""
    return _project_kv(p, memory, cfg, positions=None)


def attn_decode(
    p: dict,
    x: torch.Tensor,  # (B, 1, D)
    k_cache: torch.Tensor,  # (B, S_max, Hkv, hd)
    v_cache: torch.Tensor,
    pos: int,  # index of the new token
    cfg: ModelConfig,
    *,
    ring: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention; returns ``(out, k_cache, v_cache)``.

    The caches are updated IN PLACE (the new token's K/V written at its
    slot) and returned, where the reference returns updated copies.
    ``ring=True`` treats the cache as a sliding-window ring buffer of
    width S_max.
    """
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int64, device=x.device)
    q = _project_q(p, x, cfg, positions)
    k_new, v_new = _project_kv(p, x, cfg, positions)
    s_max = k_cache.shape[1]
    slot = pos % s_max if ring else min(pos, s_max - 1)
    k_cache[:, slot] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v_new[:, 0].to(v_cache.dtype)
    # ring buffers hold a rotation of the window; softmax attention does not
    # depend on the order of the keys.
    o = ref_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype), causal=False,
                      kv_len=min(pos + 1, s_max))
    return _out_proj(p, o), k_cache, v_cache
