"""Block assembly of the dense, moe and ssm families: specs, forward,
loss, prefill, decode.

The counterpart of ``repro/models/transformer.py`` for the families whose
layers are uniform, on one device (sharding comes later: ROADMAP Queue 1
item 8).  The parameter tree has the reference's keys and its stacked
``layers`` leaves (leading dim ``n_layers``); blocks run in a Python
loop over the layers, where the reference scans.  A block is a pre-norm
mixer then, where the family has one, a pre-norm FFN, both residual; the
kinds per family are the reference's ``_uniform_kind``:

* dense: attention, then the SwiGLU MLP;
* moe:   attention, then the mixture of experts (:mod:`.moe`), whose
  load-balancing loss :func:`forward` sums over the layers;
* ssm:   the Mamba-2 mixer (:mod:`.ssm`) alone.

Three modes share the block code: ``forward(mode="train")`` (what
:func:`lm_loss` runs) builds no cache and runs each block under
``cfg.remat``; ``forward(mode="prefill")`` runs the prompt and hands back
every layer's cache entry (attention K/V, or the Mamba conv tails and
float32 state); ``decode_step`` runs one token against the cache and
updates the cache IN PLACE.  The hybrid, vlm and encdec families never
reach this module: their :class:`ModelConfig` raises
``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import ParamSpec, materialize, tree_leaves, tree_map
from repro_torch.models.layers import (
    chunked_cross_entropy,
    cross_entropy,
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
    "lm_loss",
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


def _uniform_kind(cfg: ModelConfig) -> tuple[str, str | None]:
    """(mixer, ffn kind) of every layer of a uniform family."""
    if cfg.family == "ssm":
        return "mamba", None
    return "attn", "moe" if cfg.n_experts > 0 else ("mlp" if cfg.d_ff else None)


def param_specs(cfg: ModelConfig) -> dict:
    mixer, ffn = _uniform_kind(cfg)
    if mixer == "mamba":
        block = {"ln1": _norm_spec(cfg), "mamba": ssm_mod.ssm_specs(cfg)}
    else:
        block = {"ln1": _norm_spec(cfg), "attn": attn.attn_specs(cfg)}
    if ffn is not None:
        block["ln2"] = _norm_spec(cfg)
        block["ffn"] = moe_mod.moe_specs(cfg) if ffn == "moe" else mlp_specs(cfg)
    return {"embed": embed_specs(cfg), "layers": _stack_specs(block, cfg.n_layers)}


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random parameters on ``device`` from ``generator`` (on that device)."""
    return materialize(param_specs(cfg), generator, device)


def _unstack(stacked: dict) -> list[dict]:
    """The per-layer parameter trees of the stacked ``layers`` leaves.  One
    ``unbind`` per leaf, so that autograd stacks the layers' gradients once
    (indexing each layer instead would add a leaf-sized zero tensor a
    layer)."""
    layers = tree_map(lambda a: a.unbind(0), stacked)
    n = len(tree_leaves(layers)[0])
    return [tree_map(lambda t, i=i: t[i], layers) for i in range(n)]


def _ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig, kind: str | None):
    """x plus the block's FFN, and the layer's aux loss."""
    if kind is None:
        return x, 0.0
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if kind == "moe":
        out, aux = moe_mod.moe_apply(lp["ffn"], h, cfg)
        return x + out, aux
    return x + mlp_apply(lp["ffn"], h), 0.0


def _block(lp: dict, x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig, mode: str):
    """One layer: ``(x, aux loss, cache entry)``, the entry None unless
    ``mode="prefill"``."""
    mixer, ffn = _uniform_kind(cfg)
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    entry = None
    if mixer == "mamba":
        if mode == "prefill":
            out, entry = ssm_mod.ssm_apply(lp["mamba"], h, cfg, return_cache=True)
        else:
            out = ssm_mod.ssm_apply(lp["mamba"], h, cfg)
    else:
        out, kv = attn.attn_apply(lp["attn"], h, cfg, positions, window=cfg.sliding_window)
        if mode == "prefill":
            entry = kv
    x, aux = _ffn(lp, x + out, cfg, ffn)
    return x, aux, entry


#: Products whose outputs ``remat="dots"`` keeps (JAX's ``checkpoint_dots``).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: ModelConfig):
    """The reference's ``_maybe_remat`` (``transformer.py:237-243``): "full"
    keeps each block's inputs only and recomputes the block in the
    backward; "dots" keeps the outputs of its matrix products as well."""
    if cfg.remat == "none":
        return fn
    kwargs = {"use_reentrant": False}
    if cfg.remat == "dots":
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _save_dots)
    return lambda *args: checkpoint(fn, *args, **kwargs)


def forward(
    params: dict,
    batch: dict,
    cfg: ModelConfig,
    *,
    mode: str = "prefill",
) -> tuple[torch.Tensor, torch.Tensor | float, list | None]:
    """Full-sequence forward over ``batch["tokens"]`` (B, S) [with
    optional ``positions``].  Returns ``(hidden (B, S, D), aux_loss,
    caches)``: the final-normed hidden states, the MoE load-balancing
    loss summed over the layers (0.0 where there is none), and with
    ``mode="prefill"`` each layer's cache entry (attention ``(k, v)``
    (B, S, Hkv, hd), or the Mamba ``{"conv_x", "conv_bc", "state"}``),
    else None.  ``mode="train"`` builds no cache entry and runs each
    block under ``cfg.remat``."""
    if mode not in ("prefill", "train"):
        raise ValueError(f"unknown mode {mode!r}")
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], tokens, cfg)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device).expand(tokens.shape)

    def body(lp, x):
        return _block(lp, x, positions, cfg, mode)

    if mode == "train":
        body = _maybe_remat(body, cfg)
    caches = [] if mode == "prefill" else None
    aux = 0.0
    for lp in _unstack(params["layers"]):
        x, aux_l, entry = body(lp, x)
        aux = aux + aux_l
        if caches is not None:
            caches.append(entry)
    x = rms_norm(x, params["embed"]["final_norm"], cfg.norm_eps)
    return x, aux, caches


def lm_loss(params: dict, batch: dict, cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy (+ MoE aux), as the reference's
    ``lm_loss`` (``transformer.py:396-413``).  batch: tokens, labels (B,
    S), a label < 0 masked.  Returns ``(loss, {"ce", "aux", "loss"})``."""
    x, aux, _ = forward(params, batch, cfg, mode="train")
    labels = batch["labels"]
    if cfg.logit_chunk:
        w = params["embed"].get("head")
        if w is None:
            w = params["embed"]["tok"].T
        ce = chunked_cross_entropy(x, w, labels, None, cfg.logit_chunk)
    else:
        ce = cross_entropy(unembed(params["embed"], x, cfg), labels)
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """Zeroed serving cache ``{"layers": {...}}``, each leaf stacked over
    the layers: attention ``k`` and ``v`` (L, B, S, Hkv, hd) in the
    working type, S = min(max_len, window); or the Mamba ``conv_x``,
    ``conv_bc`` (working type) and ``state`` (float32), which do not grow
    with max_len."""
    if cfg.family == "ssm":
        dtypes = {"conv_x": cfg.dtype, "conv_bc": cfg.dtype, "state": torch.float32}
        return {"layers": {name: torch.zeros((cfg.n_layers, *shape), dtype=dtypes[name],
                                             device=device)
                           for name, shape in ssm_mod.ssm_cache_shape(cfg, batch).items()}}
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
    trailing window in ring layout (token t at slot t % window); Mamba
    layers hand over their conv tails and state as they are.
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    x, _, entries = forward(params, batch, cfg, mode="prefill")
    x = rms_norm(x, params["embed"]["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg)
    cache = init_cache(cfg, b, max_len, tokens.device)
    layers = cache["layers"]
    if cfg.family == "ssm":
        for i, entry in enumerate(entries):
            for name, t in entry.items():
                layers[name][i] = t
        return logits, cache
    target = layers["k"].shape[2]
    for i, (k, v) in enumerate(entries):
        if s >= target:  # keep the trailing window
            k, v = k[:, s - target:], v[:, s - target:]
            if cfg.sliding_window:
                shift = (s - target) % target
                k, v = torch.roll(k, shift, dims=1), torch.roll(v, shift, dims=1)
        layers["k"][i, :, : k.shape[1]] = k
        layers["v"][i, :, : v.shape[1]] = v
    return logits, cache


def decode_step(params: dict, token: torch.Tensor, cache: dict, pos: int,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One serving step: logits (B, 1, V) float32 for the token after
    ``token`` (B, 1) at position ``pos``.  The cache is updated IN PLACE
    and returned."""
    mixer, ffn = _uniform_kind(cfg)
    x = embed_tokens(params["embed"], token, cfg)
    layers = cache["layers"]
    for i, lp in enumerate(_unstack(params["layers"])):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if mixer == "mamba":
            out, _ = ssm_mod.ssm_decode(lp["mamba"], h, tree_map(lambda a: a[i], layers), cfg)
        else:
            out, _, _ = attn.attn_decode(lp["attn"], h, layers["k"][i], layers["v"][i], pos,
                                         cfg, ring=cfg.sliding_window is not None)
        x, _ = _ffn(lp, x + out, cfg, ffn)
    x = rms_norm(x, params["embed"]["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg), cache
