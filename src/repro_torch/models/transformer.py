"""Block assembly of the dense family: specs, prefill forward, decode.

The counterpart of ``repro/models/transformer.py`` for the dense family
on one device (sharding comes later: ROADMAP Queue 1 item 8).  The
parameter tree has the reference's keys and its stacked ``layers``
leaves (leading dim ``n_layers``); blocks run in a Python loop over the
layers, where the reference scans.  Each block is pre-norm attention
then a pre-norm SwiGLU MLP, both residual.

Two modes share the block code: ``forward(mode="prefill")`` runs the
prompt and hands back every layer's K/V, ``decode_step`` runs one token
against the cache and updates the cache IN PLACE.  Other families
never reach this module: their :class:`ModelConfig` raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import ParamSpec, materialize, tree_map
from repro_torch.models.layers import (
    embed_specs,
    embed_tokens,
    mlp_apply,
    mlp_specs,
    rms_norm,
    unembed,
)

__all__ = [
    "param_specs",
    "init_params",
    "forward",
    "init_cache",
    "prefill",
    "decode_step",
]


def _norm_spec(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model,), (None,), init="ones", dtype=torch.float32)


def _stack_specs(spec: Any, n: int) -> Any:
    """Prepend a stacked leading "layers" dim to every ParamSpec leaf."""
    return tree_map(
        lambda s: ParamSpec((n, *s.shape), ("layers", *s.logical), s.init, s.scale, s.dtype),
        spec,
    )


def param_specs(cfg: ModelConfig) -> dict:
    block = {"ln1": _norm_spec(cfg), "attn": attn.attn_specs(cfg),
             "ln2": _norm_spec(cfg), "ffn": mlp_specs(cfg)}
    return {"embed": embed_specs(cfg), "layers": _stack_specs(block, cfg.n_layers)}


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random parameters on ``device`` from ``generator`` (on that device)."""
    return materialize(param_specs(cfg), generator, device)


def _layer(stacked: dict, i: int) -> dict:
    return tree_map(lambda a: a[i], stacked)


def _ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return x + mlp_apply(lp["ffn"], rms_norm(x, lp["ln2"], cfg.norm_eps))


def forward(
    params: dict,
    batch: dict,
    cfg: ModelConfig,
    *,
    mode: str = "prefill",
) -> tuple[torch.Tensor, float, list | None]:
    """Full-sequence forward over ``batch["tokens"]`` (B, S) [with
    optional ``positions``].  Returns ``(hidden (B, S, D), aux_loss,
    caches)``: the final-normed hidden states, 0.0 (the dense family has
    no auxiliary loss), and with ``mode="prefill"`` each layer's
    ``(k, v)`` (B, S, Hkv, hd), else None."""
    if mode not in ("prefill", "train"):
        raise ValueError(f"unknown mode {mode!r}")
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], tokens, cfg)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)
    caches = [] if mode == "prefill" else None
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        out, kv = attn.attn_apply(lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                                  positions, window=cfg.sliding_window)
        x = _ffn(lp, x + out, cfg)
        if caches is not None:
            caches.append(kv)
    x = rms_norm(x, params["embed"]["final_norm"], cfg.norm_eps)
    return x, 0.0, caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """Zeroed serving cache: ``{"layers": {"k", "v"}}``, each
    (L, B, S, Hkv, hd) in the working type, S = min(max_len, window)."""
    window = cfg.sliding_window
    s = min(max_len, window) if window else max_len
    shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.hd)
    return {"layers": {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                       "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}}


def prefill(params: dict, batch: dict, cfg: ModelConfig, max_len: int) -> tuple[torch.Tensor, dict]:
    """Run the prompt and build the decode cache: ``(logits (B, S, V)
    float32, cache)``.

    As the reference's ``prefill`` (``transformer.py:607``) does, the
    final norm is applied once more to the forward's (already normed)
    output before the unembedding.  Sliding-window caches keep the
    trailing window in ring layout (token t at slot t % window).
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    x, _, kvs = forward(params, batch, cfg, mode="prefill")
    x = rms_norm(x, params["embed"]["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg)
    cache = init_cache(cfg, b, max_len, tokens.device)
    target = cache["layers"]["k"].shape[2]
    for i, (k, v) in enumerate(kvs):
        if s >= target:  # keep the trailing window
            k, v = k[:, s - target:], v[:, s - target:]
            if cfg.sliding_window:
                shift = (s - target) % target
                k, v = torch.roll(k, shift, dims=1), torch.roll(v, shift, dims=1)
        cache["layers"]["k"][i, :, : k.shape[1]] = k
        cache["layers"]["v"][i, :, : v.shape[1]] = v
    return logits, cache


def decode_step(params: dict, token: torch.Tensor, cache: dict, pos: int,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One serving step: logits (B, 1, V) float32 for the token after
    ``token`` (B, 1) at position ``pos``.  The cache is updated IN PLACE
    and returned."""
    x = embed_tokens(params["embed"], token, cfg)
    ks, vs = cache["layers"]["k"], cache["layers"]["v"]
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        out, _, _ = attn.attn_decode(lp["attn"], rms_norm(x, lp["ln1"], cfg.norm_eps),
                                     ks[i], vs[i], pos, cfg,
                                     ring=cfg.sliding_window is not None)
        x = _ffn(lp, x + out, cfg)
    x = rms_norm(x, params["embed"]["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg), cache
