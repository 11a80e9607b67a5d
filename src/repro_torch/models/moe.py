"""Mixture-of-Experts FFN: top-k router, capacity dispatch, grouped GEMM.

The counterpart of ``repro/models/moe.py`` (its ``einsum`` mode, which is
what its ``moe_apply`` runs).  Tokens are processed in groups of
``moe_group``; per group each expert takes at most ``cap`` tokens in
arrival order (FIFO), and a (token, choice) pair past its expert's
capacity is dropped.  Dispatch and combine are one-hot contractions
(``torch.einsum``), as the reference's; the per-expert SwiGLU FFN is
:func:`repro_torch.kernels.moe_gemm.moe_ffn`, the ``moe_ffn_fwd`` kernel
on the card, called once a layer with the groups folded into each
expert's rows.  The load-balancing aux loss follows Switch/Mixtral:
``E * sum_e f_e * P_e``.  Under a mesh the whole layer runs on each
rank's shard (:func:`_moe_meshed`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gemm import moe_ffn
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import ParamSpec
from repro_torch.parallel.sharding import (
    ShardingCtx,
    contiguous_grads,
    is_dtensor,
    local_call,
    shard_start,
)

_NO_MESH = ShardingCtx.none()

__all__ = ["moe_specs", "moe_apply", "capacity"]

def moe_specs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, e), ("embed", "experts"), dtype=torch.float32),
        "wg": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"), dtype=cfg.pdtype),
        "wu": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"), dtype=cfg.pdtype),
        "wd": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed"), dtype=cfg.pdtype),
    }


def _router(router, xt, cfg: ModelConfig):
    """Router: top-k choices of the float32 softmax and their renormalized
    gates, with the probabilities (N, E) and the one-hot (N, E) of each
    token's first choice, the aux loss's inputs."""
    probs = torch.softmax(xt.float() @ router, dim=-1)  # (N, E)
    gate_vals, choice = torch.topk(probs, cfg.top_k, dim=-1)  # (N, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    top1 = F.one_hot(choice[:, 0], cfg.n_experts).float()
    return choice, gate_vals, probs, top1


def _aux_loss(f, p, cfg: ModelConfig):
    """``E * sum_e f_e * P_e``: f the share of tokens whose first choice is
    each expert, P the mean router probability of each."""
    return cfg.n_experts * torch.sum(f * p) * cfg.router_aux_weight


def _route(p, xt, cfg: ModelConfig):
    """Router: top-k choices of the float32 softmax, renormalized gates,
    aux loss."""
    choice, gate_vals, probs, top1 = _router(p["router"], xt, cfg)
    return choice, gate_vals, _aux_loss(top1.mean(0), probs.mean(0), cfg)


def _slot_positions(choice: torch.Tensor, e: int, cap: int):
    """Position of each (token, k) pair within its expert's buffer (FIFO,
    token-major); choice (..., n, k).  Returns (pos, keep)."""
    *lead, n, k = choice.shape
    flat = F.one_hot(choice.reshape(*lead, n * k), e)  # (..., N*k, E)
    pos = (torch.cumsum(flat, dim=-2) - flat).reshape(*lead, n, k, e)
    pos = torch.gather(pos, -1, choice[..., None])[..., 0]  # (..., N, k)
    return pos, pos < cap


def capacity(cfg: ModelConfig, n: int) -> tuple[int, int]:
    """(group size, per-group capacity) for ``n`` tokens, as the
    reference: one group when ``n`` is no multiple of ``moe_group``, and
    the capacity rounded up to a multiple of 8 (at least 8)."""
    g = min(cfg.moe_group, n)
    if n % g:
        g = n
    return g, max(int(cfg.capacity_factor * cfg.top_k * g / cfg.n_experts) + 7 & ~7, 8)


def _dispatch_ffn(xt, choice, gate_vals, wg, wu, wd, cfg: ModelConfig, g: int, cap: int,
                  e_off: int = 0):
    """Dispatch the (token, choice) pairs of ``xt`` (N, D) in groups of
    ``g`` tokens, at most ``cap`` a group an expert, through the experts
    ``e_off`` to ``e_off + wg.shape[0] - 1`` (all of them unmeshed; a
    rank's own under a mesh) and combine them: (N, D), the other experts'
    pairs adding nothing."""
    n, d = xt.shape
    e, e_loc = cfg.n_experts, wg.shape[0]
    ng = n // g
    xg = xt.reshape(ng, g, d)
    cg = choice.reshape(ng, g, -1)
    pos, keep = _slot_positions(cg, e, cap)  # per group

    eh = F.one_hot(cg, e)[..., e_off:e_off + e_loc].to(xt.dtype)  # (ng, g, k, E_loc)
    ch = F.one_hot(torch.where(keep, pos, cap), cap + 1)[..., :cap].to(xt.dtype)  # OOB -> 0
    disp = torch.einsum("nske,nskc->nsec", eh, ch)  # (ng, g, E_loc, cap)
    comb = torch.einsum("nske,nskc,nsk->nsec", eh, ch, gate_vals.reshape(ng, g, -1).to(xt.dtype))
    # the groups folded into each expert's rows: (E_loc, ng * cap, D), one kernel call
    xe = torch.einsum("nsec,nsd->encd", disp, xg).reshape(e_loc, ng * cap, d)
    ye = moe_ffn(xe.contiguous(), wg, wu, wd).reshape(e_loc, ng, cap, d)
    out = torch.einsum("nsec,encd->nsd", comb, ye)
    return out.reshape(n, d)


def _moe_meshed(p: dict, x, cfg: ModelConfig, ctx: ShardingCtx):
    """:func:`moe_apply` on DTensors: routing, dispatch, the expert FFN and
    the combine run on each rank's shard through ``local_map``, with the
    placements the reference's constraints give (``moe.py:89-94``): the
    tokens keep their batch shards where every dispatch group lies in one
    shard (else they are gathered), and each rank dispatches only to its
    own experts (experts over "model") or its own slice of every expert's
    FFN (the FFN dim over "model").  Over those model axes the output and
    the router's statistics are partial sums, reduced when the caller
    constrains them."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = ctx.mesh
    b, s, d = x.shape
    n, e = b * s, cfg.n_experts
    g, cap = capacity(cfg, n)
    xt = ctx.constrain(x.reshape(n, d), ("batch", "act_embed"))
    sizes = mesh.shape
    split = 1
    for i, a in enumerate(xt.placements):
        if a == Shard(0):
            split *= sizes[i]
    local_groups = n % split == 0 and (n // split) % g == 0
    tok, gpl, dpl, out, stats, xgrad, rgrad, wgrad = [], [], [], [], [], [], [], []
    expert_ranks = 1
    for i, (a, w) in enumerate(zip(xt.placements, p["wg"].placements)):
        if w in (Shard(0), Shard(2)):  # experts, or the FFN dim, over this axis
            expert_ranks *= sizes[i]
            tok.append(Replicate()), gpl.append(w), dpl.append(Shard(0 if w == Shard(0) else 1))
            out.append(Partial()), stats.append(Partial()), xgrad.append(Partial())
            rgrad.append(Partial()), wgrad.append(None)
        elif a == Shard(0) and local_groups:  # the tokens' own shard
            tok.append(Shard(0)), gpl.append(Replicate()), dpl.append(Replicate())
            out.append(Shard(0)), stats.append(Partial()), xgrad.append(Shard(0))
            rgrad.append(Partial()), wgrad.append(Partial())
        else:
            tok.append(Replicate()), gpl.append(Replicate()), dpl.append(Replicate())
            out.append(Replicate()), stats.append(Replicate()), xgrad.append(Replicate())
            rgrad.append(Replicate()), wgrad.append(Replicate())
    rep = tuple(Replicate() for _ in sizes)
    gg = tuple(w or pl for w, pl in zip(wgrad, gpl))
    dg = tuple(w or pl for w, pl in zip(wgrad, dpl))
    e_off, _ = shard_start(e, mesh, tuple(gpl), 0)

    def local(xt, router, wg, wu, wd):
        xt, router, wg, wu, wd = contiguous_grads(xt, router, wg, wu, wd)
        choice, gate_vals, probs, top1 = _router(router, xt, cfg)
        y = _dispatch_ffn(xt, choice, gate_vals, wg, wu, wd, cfg, g, cap, e_off)
        return y, top1.sum(0) / expert_ranks, probs.sum(0) / expert_ranks

    y, top1, prob = local_call(
        local, (xt, p["router"], p["wg"], p["wu"], p["wd"]),
        (tuple(tok), rep, tuple(gpl), tuple(gpl), tuple(dpl)),
        (tuple(out), tuple(stats), tuple(stats)), mesh,
        (tuple(xgrad), tuple(rgrad), gg, gg, dg))
    return y.reshape(b, s, d), _aux_loss(top1 / n, prob / n, cfg)


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
              ctx: ShardingCtx = _NO_MESH) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D) in x's type, aux load-balance loss scalar)."""
    b, s, d = x.shape
    if is_dtensor(x):
        out, aux = _moe_meshed(p, x, cfg, ctx)
    else:
        xt = x.reshape(b * s, d)
        choice, gate_vals, aux = _route(p, xt, cfg)
        g, cap = capacity(cfg, b * s)
        out = _dispatch_ffn(xt, choice, gate_vals, p["wg"], p["wu"], p["wd"], cfg, g, cap)
    return ctx.constrain(out.reshape(b, s, d).to(x.dtype), ("batch", "seq", "act_embed")), aux
