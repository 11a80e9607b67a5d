"""Optimizers: AdamW and Adafactor, with global-norm clipping.

The counterpart of ``repro/optim/adamw.py``.  The state is a tree
congruent with the parameters (nested dicts; Adafactor's factored second
moment is a ``(row, col)`` tuple at its parameter's place), and
:func:`apply_updates` updates the parameters and the moments IN PLACE,
where the reference returns new trees: the arithmetic is the reference's
(``adamw.py:110-145``), in float32 whatever the parameter and moment
types, each result cast back to its tensor's type.  A float32 moment is
its own working copy, so it takes no second buffer.  The step is a host
integer, and the bias corrections are computed on the host in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.models.init import tree_leaves, tree_map

__all__ = [
    "OptConfig",
    "OptState",
    "adamw_init",
    "adafactor_init",
    "apply_updates",
    "global_norm",
]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4  # peak; schedules multiply this
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # "bfloat16" halves optimizer memory
    kind: str = "adamw"  # "adamw" | "adafactor"
    factored_min_size: int = 128  # adafactor: factor 2D tensors >= this


@dataclasses.dataclass
class OptState:
    step: int
    mu: Any  # first moment
    nu: Any  # second moment | (row, col) factored pair


def adamw_init(params: Any, cfg: OptConfig) -> OptState:
    dt = getattr(torch, cfg.moment_dtype)
    # zeros_like: under a mesh each moment is a DTensor placed as its parameter
    mu = tree_map(lambda p: torch.zeros_like(p, dtype=dt), params)
    nu = tree_map(lambda p: torch.zeros_like(p, dtype=dt), params)
    return OptState(step=0, mu=mu, nu=nu)


def _factorable(p: torch.Tensor, cfg: OptConfig) -> bool:
    return p.dim() >= 2 and min(p.shape[-2:]) >= cfg.factored_min_size


def adafactor_init(params: Any, cfg: OptConfig) -> OptState:
    dt = getattr(torch, cfg.moment_dtype)

    def zeros(shape, p):
        return torch.zeros(shape, dtype=dt, device=p.device)

    def nu_of(p):
        if _factorable(p, cfg):
            return zeros(p.shape[:-1], p), zeros(p.shape[:-2] + p.shape[-1:], p)
        return zeros(p.shape, p)

    mu = tree_map(lambda p: zeros(p.shape, p), params)  # keep momentum
    return OptState(step=0, mu=mu, nu=tree_map(nu_of, params))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a 0-d tensor)."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree)))


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A float32 working copy of ``t``, or ``t`` itself when it is float32."""
    return t if t.dtype == torch.float32 else t.float()


def _store(t: torch.Tensor, value: torch.Tensor) -> None:
    if value is not t:
        t.copy_(value)


@torch.no_grad()
def apply_updates(
    params: Any,
    grads: Any,
    state: OptState,
    cfg: OptConfig,
    lr_scale: float = 1.0,
) -> OptState:
    """One optimizer step, IN PLACE on ``params`` and the moments of
    ``state``; returns the state with the step advanced."""
    step = state.step + 1
    scale = torch.clamp(cfg.clip_norm / torch.clamp(global_norm(grads), min=1e-12), max=1.0)
    lr = float(np.float32(cfg.lr) * np.float32(lr_scale))
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))

    def update_param(p, direction):
        p.copy_(p.float() - lr * (direction + wd * p.float()))

    def upd_adamw(p, g, mu, nu):
        g = g.float() * scale
        mu_n = _f32(mu).mul_(b1).add_((1 - b1) * g)
        nu_n = _f32(nu).mul_(b2).add_((1 - b2) * g * g)
        update_param(p, (mu_n / bc1) / (torch.sqrt(nu_n / bc2) + eps))
        _store(mu, mu_n)
        _store(nu, nu_n)

    def upd_adafactor(p, g, mu, nu):
        g = g.float() * scale
        g2 = g * g + 1e-30
        if isinstance(nu, tuple):
            r, c = nu
            r_n = _f32(r).mul_(b2).add_((1 - b2) * g2.mean(-1))
            c_n = _f32(c).mul_(b2).add_((1 - b2) * g2.mean(-2))
            denom = (r_n[..., None] * c_n[..., None, :]
                     / torch.clamp(r_n.mean(-1)[..., None, None], min=1e-30))
            nu_hat = denom / bc2
            _store(r, r_n)
            _store(c, c_n)
        else:
            nu_f = _f32(nu).mul_(b2).add_((1 - b2) * g2)
            nu_hat = nu_f / bc2
            _store(nu, nu_f)
        mu_n = _f32(mu).mul_(b1).add_((1 - b1) * g)
        update_param(p, (mu_n / bc1) * torch.rsqrt(nu_hat + eps))
        _store(mu, mu_n)

    upd = upd_adamw if cfg.kind == "adamw" else upd_adafactor
    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
                            tree_leaves(state.nu)):
        upd(p, g, mu, nu)
    return OptState(step=step, mu=state.mu, nu=state.nu)
