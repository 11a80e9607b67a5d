"""Block assembly of every family: specs, forward, loss, prefill,
``prime_memory``, decode.

The counterpart of ``repro/models/transformer.py``.  The parameter tree has
the reference's keys and its stacked leaves; blocks run in a Python loop
where the reference scans.  A block is a pre-norm mixer then, where it
has one, a pre-norm FFN, both residual:

* dense, moe, ssm: uniform ``layers`` stacked over ``n_layers``, the
  kinds the reference's ``_uniform_kind`` gives (attention and the
  SwiGLU MLP; attention and the mixture of experts (:mod:`.moe`), whose
  load-balancing loss :func:`forward` sums over the layers; the Mamba-2
  mixer (:mod:`.ssm`) alone);
* hybrid (Jamba) and vlm (Llama-3.2-Vision): ``periods`` stacked over
  ``n_layers / period`` with one subtree ``pos{i}`` a position of the
  period (:func:`_period_structure`).  Jamba's position ``attn_offset``
  is attention and the rest Mamba, odd positions with MoE FFNs and even
  ones with MLPs; the vision model's position 0 is a gated cross-attention
  block into the image embeddings, whose K/V each period projects from
  the raw embeddings with its own weights;
* encdec (Seamless): a bidirectional encoder stack ``enc_layers`` over
  the frame embeddings (with RoPE), ``enc_norm``, then decoder ``layers``
  of causal self attention, an ungated cross attention (``ln_x``,
  ``xattn``) into the encoder's output, and the MLP.

Three modes share the block code: ``forward(mode="train")`` (what
:func:`lm_loss` runs) builds no cache and runs each layer (a period, for
the period families) under ``cfg.remat``; ``forward(mode="prefill")``
runs the prompt and hands back every layer's cache entry (attention K/V,
or the Mamba conv tails and float32 state); ``decode_step`` runs one
token against the cache and updates the cache IN PLACE.  Cross attention
decodes against the stacked memory K/V of :func:`prime_memory`.

Under a mesh every entry point takes a ``ctx``
(:class:`~repro_torch.parallel.sharding.ShardingCtx`): the parameters,
the batch and the cache are DTensors, the activations are constrained
where the reference constrains them, and the kernels run on each rank's
shard (``kernels/*/ops.py``).  The default ``ShardingCtx.none()``
changes nothing.  :func:`param_logical` and :func:`cache_logical` give
the logical axes of every leaf, :func:`abstract_params` and
:func:`abstract_cache` the trees on the ``meta`` device (the dry run's
stand-ins; nothing is allocated).
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
from repro_torch.parallel.sharding import (
    ShardingCtx,
    is_dtensor,
    local_zeros,
    replicate_like,
    shard_start,
)
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
    "param_logical",
    "abstract_params",
    "init_params",
    "encode",
    "forward",
    "lm_loss",
    "init_cache",
    "cache_logical",
    "abstract_cache",
    "prefill",
    "prime_memory",
    "MEMORY_LOGICAL",
    "decode_step",
]


_NO_MESH = ShardingCtx.none()


def _norm_spec(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model,), (None,), init="ones", dtype=torch.float32)


def _attn_block_specs(cfg: ModelConfig, moe: bool, cross: bool = False) -> dict:
    specs = {"ln1": _norm_spec(cfg), "attn": attn.attn_specs(cfg, cross=cross)}
    if cfg.d_ff or moe:
        specs["ln2"] = _norm_spec(cfg)
        specs["ffn"] = moe_mod.moe_specs(cfg) if moe else mlp_specs(cfg)
    return specs


def _mamba_block_specs(cfg: ModelConfig, ffn: str | None = None) -> dict:
    specs = {"ln1": _norm_spec(cfg), "mamba": ssm_mod.ssm_specs(cfg)}
    if ffn is not None:
        specs["ln2"] = _norm_spec(cfg)
        specs["ffn"] = moe_mod.moe_specs(cfg) if ffn == "moe" else mlp_specs(cfg)
    return specs


def _stack_specs(spec: Any, n: int, axis_name: str = "layers") -> Any:
    """Prepend a stacked leading dim, named ``axis_name``, to every
    ParamSpec leaf."""
    return tree_map(
        lambda s: ParamSpec((n, *s.shape), (axis_name, *s.logical), s.init, s.scale, s.dtype),
        spec,
    )


def _uniform_kind(cfg: ModelConfig) -> tuple[str, str | None]:
    """(mixer, ffn kind) of every layer of a uniform family."""
    if cfg.family == "ssm":
        return "mamba", None
    return "attn", "moe" if cfg.n_experts > 0 else ("mlp" if cfg.d_ff else None)


def _period_structure(cfg: ModelConfig) -> list[tuple[str, str]]:
    """(mixer, ffn kind) of each position of a period (hybrid, vlm)."""
    if cfg.family == "hybrid":
        return [("attn" if pos == cfg.attn_offset else "mamba",
                 "moe" if cfg.is_moe_layer(pos) else "mlp") for pos in range(cfg.attn_period)]
    if cfg.family == "vlm":
        return [("cross", "mlp")] + [("attn", "mlp")] * (cfg.cross_attn_period - 1)
    raise ValueError(cfg.family)


def _n_periods(cfg: ModelConfig, period: list) -> int:
    if cfg.n_layers % len(period):
        raise ValueError(f"{cfg.n_layers} layers not divisible by period {len(period)}")
    return cfg.n_layers // len(period)


def param_specs(cfg: ModelConfig) -> dict:
    specs: dict = {"embed": embed_specs(cfg)}
    fam = cfg.family
    if fam in ("dense", "moe"):
        specs["layers"] = _stack_specs(_attn_block_specs(cfg, moe=cfg.n_experts > 0),
                                       cfg.n_layers)
    elif fam == "ssm":
        specs["layers"] = _stack_specs(_mamba_block_specs(cfg), cfg.n_layers)
    elif fam in ("hybrid", "vlm"):
        period = _period_structure(cfg)
        pos_specs = {}
        for i, (mixer, ffn) in enumerate(period):
            if mixer == "mamba":
                pos_specs[f"pos{i}"] = _mamba_block_specs(cfg, ffn)
            else:
                pos_specs[f"pos{i}"] = _attn_block_specs(cfg, moe=ffn == "moe",
                                                         cross=mixer == "cross")
        specs["periods"] = _stack_specs(pos_specs, _n_periods(cfg, period), "periods")
    elif fam == "encdec":
        dec_block = _attn_block_specs(cfg, moe=False)
        dec_block["ln_x"] = _norm_spec(cfg)
        dec_block["xattn"] = attn.attn_specs(cfg)  # ungated: no "gate"
        specs["enc_layers"] = _stack_specs(_attn_block_specs(cfg, moe=False), cfg.n_enc_layers)
        specs["layers"] = _stack_specs(dec_block, cfg.n_layers)
        specs["enc_norm"] = _norm_spec(cfg)
    else:
        raise ValueError(fam)
    return specs


def param_logical(cfg: ModelConfig) -> dict:
    """The logical axes of every parameter leaf (``ParamSpec.logical``)."""
    return tree_map(lambda s: s.logical, param_specs(cfg))


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree on the ``meta`` device: shapes and types only."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                    param_specs(cfg))


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random parameters on ``device`` from ``generator`` (on that device)."""
    return materialize(param_specs(cfg), generator, device)


def _unstack(stacked: dict) -> list[dict]:
    """The per-layer (or per-period) parameter trees of stacked leaves.
    One ``unbind`` per leaf, so that autograd stacks the layers' gradients
    once (indexing each layer instead would add a leaf-sized zero tensor a
    layer)."""
    layers = tree_map(lambda a: a.unbind(0), stacked)
    n = len(tree_leaves(layers)[0])
    return [tree_map(lambda t, i=i: t[i], layers) for i in range(n)]


def _ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig, kind: str | None, ctx: ShardingCtx):
    """x plus the block's FFN, and the layer's aux loss."""
    if kind is None or "ffn" not in lp:
        return x, 0.0
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if kind == "moe":
        out, aux = moe_mod.moe_apply(lp["ffn"], h, cfg, ctx)
        return x + out, aux
    return x + mlp_apply(lp["ffn"], h, ctx), 0.0


def _block(lp: dict, x: torch.Tensor, positions: torch.Tensor | None, cfg: ModelConfig,
           mode: str, *, mixer: str, ffn_kind: str | None, memory=None,
           window: int | None = None, causal: bool = True, ctx: ShardingCtx = _NO_MESH):
    """One layer over a whole sequence: ``(x, aux loss, cache entry)``, the
    entry None unless ``mode="prefill"`` and the mixer keeps one (a cross
    block's cache entry is the unused placeholder :func:`init_cache`
    makes)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    entry = None
    if mixer == "mamba":
        if mode == "prefill":
            out, entry = ssm_mod.ssm_apply(lp["mamba"], h, cfg, return_cache=True, ctx=ctx)
        else:
            out = ssm_mod.ssm_apply(lp["mamba"], h, cfg, ctx=ctx)
    elif mixer == "cross":
        out = attn.cross_attn_apply(lp["attn"], h, memory, cfg, gated=True, ctx=ctx)
    elif mixer == "attn":
        out, kv = attn.attn_apply(lp["attn"], h, cfg, positions, causal=causal, window=window,
                                  ctx=ctx)
        if mode == "prefill":
            entry = kv
    else:
        raise ValueError(mixer)
    # the block boundary: the mixer's output placed as the residual stream
    out = ctx.constrain(out, ("batch", "seq", "act_embed"))
    x, aux = _ffn(lp, x + out, cfg, ffn_kind, ctx)
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


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig, *,
           remat: bool = False, ctx: ShardingCtx = _NO_MESH) -> torch.Tensor:
    """The encoder stack over frame embeddings (B, S_enc, D) (encdec):
    bidirectional self attention with RoPE at the frames' positions and
    the MLP a layer, then ``enc_norm``.  ``remat`` runs each layer under
    ``cfg.remat`` (training)."""
    x = ctx.constrain(frames.to(cfg.dtype), ("batch", "seq", "act_embed"))
    positions = _positions(x.shape[:2], x)

    def body(lp, x):
        return _block(lp, x, positions, cfg, "train", mixer="attn", ffn_kind="mlp",
                      causal=False, ctx=ctx)[0]

    if remat:
        body = _maybe_remat(body, cfg)
    for lp in _unstack(params["enc_layers"]):
        x = body(lp, x)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _positions(shape, ref: torch.Tensor) -> torch.Tensor:
    """arange(S) over (B, S), on ``ref``'s device (a replicated DTensor
    under a mesh)."""
    return replicate_like(torch.arange(shape[1], device=ref.device).expand(tuple(shape)), ref)


def forward(
    params: dict,
    batch: dict,
    cfg: ModelConfig,
    *,
    mode: str = "prefill",
    ctx: ShardingCtx = _NO_MESH,
) -> tuple[torch.Tensor, torch.Tensor | float, list | None]:
    """Full-sequence forward over ``batch["tokens"]`` (B, S) [with
    optional ``positions``; ``image_embeds`` (B, S_img, D) for vlm,
    ``enc_frames`` (B, S_enc, D) for encdec].  Returns ``(hidden (B, S,
    D), aux_loss, caches)``: the final-normed hidden states, the MoE
    load-balancing loss summed over the layers (0.0 where there is none),
    and with ``mode="prefill"`` each layer's cache entry (attention ``(k,
    v)`` (B, S, Hkv, hd), or the Mamba ``{"conv_x", "conv_bc", "state"}``;
    for the period families a dict ``{"pos{i}": entry}`` a period, None at
    a cross position), else None.  ``mode="train"`` builds no cache entry
    and runs each layer or period under ``cfg.remat``."""
    if mode not in ("prefill", "train"):
        raise ValueError(f"unknown mode {mode!r}")
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"], tokens, cfg, ctx)
    positions = batch.get("positions")
    if positions is None:
        positions = _positions(tokens.shape, tokens)
    fam = cfg.family

    if fam in ("hybrid", "vlm"):
        period = _period_structure(cfg)
        # the vision model's periods project their own cross K/V from the
        # raw image embeddings
        image = batch["image_embeds"].to(cfg.dtype) if fam == "vlm" else None
        if image is not None:
            image = ctx.constrain(image, ("batch", "kv_seq", "act_embed"))

        def body(pp, x):
            aux, entries = 0.0, {}
            for i, (mixer, ffn_kind) in enumerate(period):
                p_i = pp[f"pos{i}"]
                mem = (attn.memory_kv(p_i["attn"], image, cfg, ctx) if mixer == "cross"
                       else None)
                x, aux_i, entries[f"pos{i}"] = _block(
                    p_i, x, positions, cfg, mode, mixer=mixer, ffn_kind=ffn_kind, memory=mem,
                    window=cfg.sliding_window, ctx=ctx)
                aux = aux + aux_i
            return x, aux, entries

        stacked = params["periods"]
    elif fam == "encdec":
        enc = encode(params, batch["enc_frames"], cfg, remat=mode == "train", ctx=ctx)

        def body(lp, x):
            x, _, entry = _block(lp, x, positions, cfg, mode, mixer="attn", ffn_kind=None,
                                 ctx=ctx)
            h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
            x = x + attn.cross_attn_apply(lp["xattn"], h,
                                          attn.memory_kv(lp["xattn"], enc, cfg, ctx), cfg,
                                          ctx=ctx)
            x, aux = _ffn(lp, x, cfg, "mlp", ctx)
            return x, aux, entry

        stacked = params["layers"]
    else:
        mixer, ffn_kind = _uniform_kind(cfg)

        def body(lp, x):
            return _block(lp, x, positions, cfg, mode, mixer=mixer, ffn_kind=ffn_kind,
                          window=cfg.sliding_window, ctx=ctx)

        stacked = params["layers"]

    if mode == "train":
        body = _maybe_remat(body, cfg)
    caches = [] if mode == "prefill" else None
    aux = 0.0
    for lp in _unstack(stacked):
        x, aux_l, entry = body(lp, x)
        aux = aux + aux_l
        if caches is not None:
            caches.append(entry)
    x = rms_norm(x, params["embed"]["final_norm"], cfg.norm_eps)
    return x, aux, caches


def lm_loss(params: dict, batch: dict, cfg: ModelConfig,
            ctx: ShardingCtx = _NO_MESH) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy (+ MoE aux), as the reference's
    ``lm_loss`` (``transformer.py:396-413``).  batch: tokens, labels (B,
    S), a label < 0 masked, and the family's extras.  Returns ``(loss,
    {"ce", "aux", "loss"})``."""
    x, aux, _ = forward(params, batch, cfg, mode="train", ctx=ctx)
    labels = batch["labels"]
    if cfg.logit_chunk:
        w = params["embed"].get("head")
        if w is None:
            w = params["embed"]["tok"].T
        ce = chunked_cross_entropy(x, w, labels, None, cfg.logit_chunk)
    else:
        ce = cross_entropy(unembed(params["embed"], x, cfg, ctx), labels)
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


def _attn_cache(cfg: ModelConfig, n: int, batch: int, max_len: int) -> dict:
    window = cfg.sliding_window
    s = min(max_len, window) if window else max_len
    shape = (n, batch, s, cfg.n_kv_heads, cfg.hd)
    return {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}


def _ssm_cache(cfg: ModelConfig, n: int, batch: int) -> dict:
    dtypes = {"conv_x": cfg.dtype, "conv_bc": cfg.dtype, "state": torch.float32}
    return {name: ((n, *shape), dtypes[name])
            for name, shape in ssm_mod.ssm_cache_shape(cfg, batch).items()}


def _cache_layout(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The cache tree with a ``(shape, dtype)`` a leaf."""
    fam = cfg.family
    if fam == "ssm":
        return {"layers": _ssm_cache(cfg, cfg.n_layers, batch)}
    if fam in ("dense", "moe", "encdec"):
        return {"layers": _attn_cache(cfg, cfg.n_layers, batch, max_len)}
    if fam in ("hybrid", "vlm"):
        period = _period_structure(cfg)
        n = _n_periods(cfg, period)
        per = {}
        for i, (mixer, _) in enumerate(period):
            if mixer == "mamba":
                per[f"pos{i}"] = _ssm_cache(cfg, n, batch)
            elif mixer == "cross":
                per[f"pos{i}"] = {"unused": ((n, 1), cfg.dtype)}
            else:
                per[f"pos{i}"] = _attn_cache(cfg, n, batch, max_len)
        return {"periods": per}
    raise ValueError(fam)


_ATTN_CACHE_LOGICAL = {
    "k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
}
_SSM_CACHE_LOGICAL = {
    "conv_x": ("layers", "batch", None, "conv_dim"),
    "conv_bc": ("layers", "batch", None, None),
    "state": ("layers", "batch", "ssm_heads", "ssm_state", None),
}


def cache_logical(cfg: ModelConfig) -> dict:
    """The logical axes of every leaf of the :func:`init_cache` tree (the
    reference's ``cache_logical``)."""
    fam = cfg.family
    if fam in ("dense", "moe", "encdec"):
        return {"layers": dict(_ATTN_CACHE_LOGICAL)}
    if fam == "ssm":
        return {"layers": dict(_SSM_CACHE_LOGICAL)}
    if fam in ("hybrid", "vlm"):
        per = {}
        for i, (mixer, _) in enumerate(_period_structure(cfg)):
            if mixer == "mamba":
                per[f"pos{i}"] = dict(_SSM_CACHE_LOGICAL)
            elif mixer == "cross":
                per[f"pos{i}"] = {"unused": ("layers", None)}
            else:
                per[f"pos{i}"] = dict(_ATTN_CACHE_LOGICAL)
        return {"periods": per}
    raise ValueError(fam)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               ctx: ShardingCtx = _NO_MESH) -> dict:
    """Zeroed serving cache, each leaf stacked over the layers (or the
    periods): attention ``k`` and ``v`` (L, B, S, Hkv, hd) in the working
    type, S = min(max_len, window); or the Mamba ``conv_x``, ``conv_bc``
    (working type) and ``state`` (float32), which do not grow with
    max_len.  Uniform and encdec families: ``{"layers": {...}}``; hybrid
    and vlm: ``{"periods": {"pos{i}": {...}}}``, a cross position holding
    the reference's placeholder ``{"unused": (n_periods, 1)}`` (its memory
    is static: :func:`prime_memory`).  Under a mesh (``ctx``, whose rules
    are the cache's) each leaf is a DTensor placed by
    :func:`cache_logical`, each rank holding only its shard."""
    layout = _cache_layout(cfg, batch, max_len)
    if ctx.mesh is None:
        return tree_map(lambda sd: torch.zeros(sd[0], dtype=sd[1], device=device), layout)
    return tree_map(lambda sd, logical: local_zeros(sd[0], sd[1], device, ctx.mesh,
                                                    ctx.placements(logical)),
                    layout, cache_logical(cfg))


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The cache tree on the ``meta`` device (the dry run's stand-in)."""
    return init_cache(cfg, batch, max_len, "meta")


def _local_like(entry: torch.Tensor, stack: torch.Tensor, whole: int | None = None):
    """A layer's cache entry (a DTensor) as this rank's local tensor, sharded
    as one layer of the DTensor ``stack`` is, but whole along the entry's
    dim ``whole`` (an attention entry's sequence) if given."""
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(Shard(a.dim - 1) if isinstance(a, Shard) and a.dim - 1 != whole else
                 Replicate() for a in stack.placements)
    return entry.redistribute(stack.device_mesh, want).to_local()


def _store(stack: dict, i: int, entry, s: int, cfg: ModelConfig) -> None:
    """Write layer ``i``'s prefill entry into the stacked cache ``stack``:
    Mamba tensors as they are; attention K/V of ``s`` tokens padded to the
    cache's length, or (s at or past it) its trailing window, in ring
    layout for a sliding window (token t at slot t % window).  A None
    entry (a cross position) leaves the placeholder.  Under a mesh each
    rank writes its own shard: the rows of the cache's sequence it holds."""
    if entry is None:
        return
    meshed = is_dtensor(next(iter(stack.values())))
    if isinstance(entry, dict):
        for name, t in entry.items():
            if meshed:
                stack[name].to_local()[i] = _local_like(t, stack[name])
            else:
                stack[name][i] = t
        return
    k, v = entry
    target = stack["k"].shape[2]
    if meshed:
        k, v = _local_like(k, stack["k"], 1), _local_like(v, stack["v"], 1)
    if s >= target:  # keep the trailing window
        k, v = k[:, s - target:], v[:, s - target:]
        if cfg.sliding_window:
            shift = (s - target) % target
            k, v = torch.roll(k, shift, dims=1), torch.roll(v, shift, dims=1)
    if not meshed:
        stack["k"][i, :, : k.shape[1]] = k
        stack["v"][i, :, : v.shape[1]] = v
        return
    off, n = shard_start(target, stack["k"].device_mesh, stack["k"].placements, 2)
    rows = max(0, min(k.shape[1] - off, n))
    stack["k"].to_local()[i, :, :rows] = k[:, off:off + rows]
    stack["v"].to_local()[i, :, :rows] = v[:, off:off + rows]


def prefill(params: dict, batch: dict, cfg: ModelConfig, max_len: int,
            ctx: ShardingCtx = _NO_MESH,
            cache_ctx: ShardingCtx | None = None) -> tuple[torch.Tensor, dict]:
    """Run the prompt (and the family's extras) and build the decode
    cache: ``(logits (B, S, V) float32, cache)``.

    As the reference's ``prefill`` (``transformer.py:607``) does, the
    final norm is applied once more to the forward's (already normed)
    output before the unembedding.  Attention entries anywhere in the
    tree (a period's attention positions too) are padded to ``max_len``
    or keep their trailing window (:func:`_store`); Mamba entries hand
    over their conv tails and state as they are.  Under a mesh the cache
    is placed by ``cache_ctx``'s rules (default ``ctx``'s).
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    x, _, entries = forward(params, batch, cfg, mode="prefill", ctx=ctx)
    x = rms_norm(x, params["embed"]["final_norm"], cfg.norm_eps)
    logits = unembed(params["embed"], x, cfg, ctx)
    local = tokens.to_local() if is_dtensor(tokens) else tokens
    cache = init_cache(cfg, b, max_len, local.device, cache_ctx or ctx)
    if "periods" in cache:
        for i, per in enumerate(entries):
            for name, entry in per.items():
                _store(cache["periods"][name], i, entry, s, cfg)
    else:
        for i, entry in enumerate(entries):
            _store(cache["layers"], i, entry, s, cfg)
    return logits, cache


#: The logical axes of :func:`prime_memory`'s stacked cross K/V, as the
#: reference's decode takes them.
MEMORY_LOGICAL = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")


def prime_memory(params: dict, cfg: ModelConfig, batch: dict, ctx: ShardingCtx = _NO_MESH):
    """The static cross-attention memory of a decode: stacked ``(k, v)``,
    each (n, B, S_mem, Hkv, hd), one entry a decoder layer (encdec: the
    encoder run over ``batch["enc_frames"]`` again, then each layer's
    ``xattn`` projections) or a period (vlm: each period's cross
    projections of ``batch["image_embeds"]``); None for the other
    families.  Under a mesh (``ctx``) the batch's extras are DTensors and
    the stacks are placed by :data:`MEMORY_LOGICAL`."""
    if cfg.family == "encdec":
        enc = encode(params, batch["enc_frames"], cfg, ctx=ctx)
        kv = [attn.memory_kv(lp["xattn"], enc, cfg, ctx) for lp in _unstack(params["layers"])]
    elif cfg.family == "vlm":
        image = batch["image_embeds"].to(cfg.dtype)
        kv = [attn.memory_kv(pp["pos0"]["attn"], image, cfg, ctx)
              for pp in _unstack(params["periods"])]
    else:
        return None
    return tuple(ctx.constrain(torch.stack(part), MEMORY_LOGICAL)
                 for part in ([k for k, _ in kv], [v for _, v in kv]))


def _decode_mixer(lp: dict, x: torch.Tensor, stack: dict, i: int, pos: int, cfg: ModelConfig,
                  mixer: str, ctx: ShardingCtx, sp: bool) -> torch.Tensor:
    """x plus one token's self-attention or Mamba mixer against layer
    ``i`` of the stacked cache ``stack``, which it updates IN PLACE."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if mixer == "mamba":
        out, _ = ssm_mod.ssm_decode(lp["mamba"], h, tree_map(lambda a: a[i], stack), cfg, ctx)
        out = ctx.constrain(out, ("batch", "seq", "act_embed"))
    else:
        out, _, _ = attn.attn_decode(lp["attn"], h, stack["k"][i], stack["v"][i], pos, cfg,
                                     ring=cfg.sliding_window is not None, sp=sp, ctx=ctx)
    return x + out


def decode_step(params: dict, token: torch.Tensor, cache: dict, pos: int,
                cfg: ModelConfig, memory=None, ctx: ShardingCtx = _NO_MESH,
                sp: bool = False) -> tuple[torch.Tensor, dict]:
    """One serving step: logits (B, 1, V) float32 for the token after
    ``token`` (B, 1) at position ``pos``.  The cache is updated IN PLACE
    and returned.  ``memory`` is :func:`prime_memory`'s stacked cross K/V,
    which the vlm and encdec families need.  ``sp`` (under a mesh) is the
    sequence-parallel decode of a long-context cache."""
    fam = cfg.family
    if fam in ("vlm", "encdec") and memory is None:
        raise ValueError(f"decode_step of the {fam} family needs prime_memory's memory")
    if ctx.mesh is not None:  # one token: no sequence to shard (the cache keeps its own)
        ctx = ShardingCtx(ctx.mesh, ctx.rules.replace(seq=None))
    x = embed_tokens(params["embed"], token, cfg, ctx)
    if fam in ("hybrid", "vlm"):
        period = _period_structure(cfg)
        for i, pp in enumerate(_unstack(params["periods"])):
            for j, (mixer, ffn_kind) in enumerate(period):
                p_j = pp[f"pos{j}"]
                if mixer == "cross":  # the cache keeps its placeholder
                    h = rms_norm(x, p_j["ln1"], cfg.norm_eps)
                    x = x + attn.cross_attn_apply(p_j["attn"], h, (memory[0][i], memory[1][i]),
                                                  cfg, gated=True, ctx=ctx)
                else:
                    x = _decode_mixer(p_j, x, cache["periods"][f"pos{j}"], i, pos, cfg, mixer,
                                      ctx, sp)
                x, _ = _ffn(p_j, x, cfg, ffn_kind, ctx)
    elif fam == "encdec":
        for i, lp in enumerate(_unstack(params["layers"])):
            x = _decode_mixer(lp, x, cache["layers"], i, pos, cfg, "attn", ctx, sp)
            h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
            x = x + attn.cross_attn_apply(lp["xattn"], h, (memory[0][i], memory[1][i]), cfg,
                                          ctx=ctx)
            x, _ = _ffn(lp, x, cfg, "mlp", ctx)
    else:
        mixer, ffn_kind = _uniform_kind(cfg)
        for i, lp in enumerate(_unstack(params["layers"])):
            x = _decode_mixer(lp, x, cache["layers"], i, pos, cfg, mixer, ctx, sp)
            x, _ = _ffn(lp, x, cfg, ffn_kind, ctx)
    x = rms_norm(x, params["embed"]["final_norm"], cfg.norm_eps)
    return unembed(params["embed"], x, cfg, ctx), cache
