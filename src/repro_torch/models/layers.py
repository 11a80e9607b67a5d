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
from repro_torch.parallel.sharding import (
    ShardingCtx,
    all_reduce,
    is_dtensor,
    local_call,
    replicate_like,
    replicated_sum,
    shard_start,
)

_NO_MESH = ShardingCtx.none()

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
    freq = replicate_like(freq, positions)
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


def mlp_apply(p: dict, x: torch.Tensor, ctx: ShardingCtx = _NO_MESH) -> torch.Tensor:
    h_g = ctx.constrain(x @ ctx.weight(p["wg"], ("embed", "mlp")), ("batch", "seq", "act_mlp"))
    h_u = ctx.constrain(x @ ctx.weight(p["wu"], ("embed", "mlp")), ("batch", "seq", "act_mlp"))
    act = (F.silu(h_g.float()) * h_u.float()).to(x.dtype)
    out = act @ ctx.weight(p["wd"], ("mlp", "embed"))
    return ctx.constrain(out, ("batch", "seq", "act_embed"))


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


def embed_tokens(p: dict, tokens: torch.Tensor, cfg: ModelConfig,
                 ctx: ShardingCtx = _NO_MESH) -> torch.Tensor:
    if is_dtensor(tokens):
        x = _embed_meshed(ctx.weight(p["tok"], ("vocab", "embed")), tokens)
    else:
        x = p["tok"][tokens]
    return ctx.constrain(x.to(cfg.dtype), ("batch", "seq", "act_embed"))


def _embed_meshed(tok, tokens):
    """The lookup of DTensor ``tokens`` in a DTensor table (the vocabulary
    sharded, its embed dim whole), vocab-parallel and shard by shard: each
    rank looks up the tokens of its own slice of the vocabulary (zeros for
    the others), a partial sum over the ranks that split it."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = tok.device_mesh
    tp = tuple(Shard(0) if a == Shard(0) else Replicate() for a in tok.placements)
    ip = tuple(Replicate() if t == Shard(0) else Shard(0) if a == Shard(0) else Replicate()
               for a, t in zip(tokens.placements, tp))
    out = tuple(Partial() if t == Shard(0) else i for t, i in zip(tp, ip))
    grad = tuple(t if t == Shard(0) else Partial() if i == Shard(0) else Replicate()
                 for t, i in zip(tp, ip))
    v_off, v_loc = shard_start(tok.shape[0], mesh, tp, 0)

    def local(t, ids):
        mine = (ids >= v_off) & (ids < v_off + v_loc)
        return t[(ids - v_off).clamp(0, v_loc - 1)] * mine[..., None].to(t.dtype)

    return local_call(local, (tok, tokens), (tp, ip), out, mesh, (grad, ip))


def unembed(p: dict, x: torch.Tensor, cfg: ModelConfig,
            ctx: ShardingCtx = _NO_MESH) -> torch.Tensor:
    """Logits over the padded vocabulary, in float32 (as the reference's
    ``layers.py:91``); the product itself runs in the working type."""
    w = p["head"] if "head" in p else p["tok"].T
    w = ctx.weight(w, ("embed", "vocab"))
    return ctx.constrain((x @ w).float(), ("batch", "seq", "act_vocab"))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  valid: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in f32; labels < 0 or ~valid are masked."""
    if valid is None:
        valid = labels >= 0
    if is_dtensor(logits):
        return _cross_entropy_meshed(logits, labels, valid)
    lab = labels.clamp(min=0).long()
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, lab[..., None])[..., 0]
    nll = (lse - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)


def _cross_entropy_meshed(logits, labels, valid) -> torch.Tensor:
    """:func:`cross_entropy` of DTensor logits, the vocabulary sharded
    (vocab-parallel): each rank takes the max, the sum of exponentials and
    the gold logit over its own slice of the vocabulary, all-reduced over
    the ranks that split it; the masked sums are then partial over the
    batch shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = logits.device_mesh
    lp = tuple(a if a in (Shard(0), Shard(2)) else Replicate() for a in logits.placements)
    tp = tuple(Shard(0) if a == Shard(0) else Replicate() for a in lp)
    out = tuple(Partial() if a == Shard(0) else Replicate() for a in lp)
    groups = [mesh.get_group(i) for i, a in enumerate(lp) if a == Shard(2)]
    v_off, v_loc = shard_start(logits.shape[-1], mesh, lp, 2)

    def local(lf, lab, valid):
        lf = lf.float()
        lab = lab.clamp(min=0).long()
        m = all_reduce(lf.detach().amax(dim=-1), "max", groups)
        sumexp = replicated_sum(torch.exp(lf - m[..., None]).sum(dim=-1), groups)
        mine = (lab >= v_off) & (lab < v_off + v_loc)
        gold = torch.gather(lf, -1, (lab - v_off).clamp(0, v_loc - 1)[..., None])[..., 0]
        gold = replicated_sum(torch.where(mine, gold, 0.0), groups)
        nll = (m + torch.log(sumexp) - gold) * valid
        return nll.sum(), valid.sum()

    nll, count = local_call(local, (logits, labels, valid), (lp, tp, tp), (out, out), mesh)
    return nll / count.clamp(min=1)


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
    m, l, gold = (replicate_like(t, x) for t in (m, l, gold))
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
