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
``E * sum_e f_e * P_e``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_gemm import moe_ffn
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import ParamSpec

__all__ = ["moe_specs", "moe_apply", "capacity"]

def moe_specs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, e), ("embed", "experts"), dtype=torch.float32),
        "wg": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"), dtype=cfg.pdtype),
        "wu": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp"), dtype=cfg.pdtype),
        "wd": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed"), dtype=cfg.pdtype),
    }


def _route(p, xt, cfg: ModelConfig):
    """Router: top-k choices of the float32 softmax, renormalized gates,
    aux loss."""
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)  # (N, E)
    gate_vals, choice = torch.topk(probs, k, dim=-1)  # (N, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    top1 = F.one_hot(choice[:, 0], e).float()
    aux = e * torch.sum(top1.mean(0) * probs.mean(0)) * cfg.router_aux_weight
    return choice, gate_vals, aux


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


def _moe_einsum(p, xt, choice, gate_vals, cfg: ModelConfig):
    n, d = xt.shape
    e = cfg.n_experts
    g, cap = capacity(cfg, n)
    ng = n // g
    xg = xt.reshape(ng, g, d)
    cg = choice.reshape(ng, g, -1)
    pos, keep = _slot_positions(cg, e, cap)  # per group

    eh = F.one_hot(cg, e).to(xt.dtype)  # (ng, g, k, E)
    ch = F.one_hot(torch.where(keep, pos, cap), cap + 1)[..., :cap].to(xt.dtype)  # OOB -> 0
    disp = torch.einsum("nske,nskc->nsec", eh, ch)  # (ng, g, E, cap)
    comb = torch.einsum("nske,nskc,nsk->nsec", eh, ch, gate_vals.reshape(ng, g, -1).to(xt.dtype))
    # the groups folded into each expert's rows: (E, ng * cap, D), one kernel call
    xe = torch.einsum("nsec,nsd->encd", disp, xg).reshape(e, ng * cap, d)
    ye = moe_ffn(xe.contiguous(), p["wg"], p["wu"], p["wd"]).reshape(e, ng, cap, d)
    out = torch.einsum("nsec,encd->nsd", comb, ye)
    return out.reshape(n, d)


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, S, D) in x's type, aux load-balance loss scalar)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    choice, gate_vals, aux = _route(p, xt, cfg)
    out = _moe_einsum(p, xt, choice, gate_vals, cfg)
    return out.reshape(b, s, d).to(x.dtype), aux
