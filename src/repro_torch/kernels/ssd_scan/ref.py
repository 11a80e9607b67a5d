"""Plain reference implementations of the Mamba-2 SSD (state-space
duality) scan.

The counterpart of ``repro/kernels/ssd_scan/ref.py``.  Semantics
(discretized selective state space, arXiv:2405.21060)::

    h[t] = exp(dt[t] * A) * h[t-1] + dt[t] * x[t] ⊗ B[t]
    y[t] = C[t] · h[t] + D * x[t]

with per-head scalar decay ``A < 0``, per-step ``dt > 0`` (softplus
applied upstream) and states h of shape (N, P) per head.

* :func:`ssd_quadratic`   — O(S²) fully materialized "attention form".
* :func:`ssd_chunked`     — O(S·C) chunked scan, a Python loop over chunks
  (:func:`chunked_scan`, in the kernel's layout, which the kernel's plain
  version runs too).
* :func:`ssd_decode_step` — the one-token recurrence that serving runs.

Shapes: x (B, S, H, P); dt (B, S, H); A (H,); Bm/Cm (B, S, G, N) with H
a multiple of G; D (H,).  Everything is computed in float32; y is cast
back to x's type, the state (B, H, N, P) stays float32.  The decay
matrix is masked with a select (``torch.where``), never a product: above
the diagonal its exponent is positive and may overflow.
"""

from __future__ import annotations

import torch

__all__ = ["ssd_quadratic", "chunked_scan", "ssd_chunked", "ssd_decode_step"]


def _expand_groups(m: torch.Tensor, h: int, axis: int = 2) -> torch.Tensor:
    """Repeat each of the G groups of ``axis`` H/G times, to H."""
    return torch.repeat_interleave(m, h // m.shape[axis], dim=axis)


def _tri(s: int, device) -> torch.Tensor:
    return torch.tril(torch.ones((s, s), dtype=torch.bool, device=device))


def ssd_quadratic(x, dt, A, Bm, Cm, D, init_state=None):
    """O(S²) materialized form: y = (C·Bᵀ ∘ L) (dt∘x) + D x."""
    _, s, h, _ = x.shape
    xf, dtf = x.float(), dt.float()
    Bf = _expand_groups(Bm.float(), h)
    Cf = _expand_groups(Cm.float(), h)
    cum = torch.cumsum(dtf * A.float(), dim=1)  # (B, S, H)
    diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B, T, S', H)
    L = torch.where(_tri(s, x.device)[None, :, :, None], torch.exp(diff), 0.0)
    scores = torch.einsum("bthn,bshn->btsh", Cf, Bf) * L
    y = torch.einsum("btsh,bshp->bthp", scores, xf * dtf[..., None])
    if init_state is not None:
        y = y + torch.einsum("bthn,bhnp->bthp", Cf * torch.exp(cum)[..., None],
                             init_state.float())
    y = y + D.float()[None, None, :, None] * xf
    w = torch.exp(cum[:, -1:, :] - cum) * dtf  # (B, S, H)
    state = torch.einsum("bshn,bshp->bhnp", Bf * w[..., None], xf)
    if init_state is not None:
        state = state + torch.exp(cum[:, -1])[:, :, None, None] * init_state.float()
    return y.to(x.dtype), state


def chunked_scan(x, dt, da, Bm, Cm, chunk: int, init_state=None):
    """The chunk loop in the kernel's layout: x (B, H, S, P); dt and
    dA = dt * A[h] (B, H, S); Bm/Cm (B, G, S, N).  Returns y (B, H, S, P)
    float32, without the D * x skip, and the final state float32."""
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    Bf = _expand_groups(Bm.float(), h, axis=1)  # (B, H, S, N)
    Cf = _expand_groups(Cm.float(), h, axis=1)
    tri = _tri(chunk, x.device)
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t0 in range(0, s, chunk):
        xc = x[:, :, t0 : t0 + chunk].float()  # (B, H, C, P)
        dtc = dt[:, :, t0 : t0 + chunk].float()
        Bc, Cc = Bf[:, :, t0 : t0 + chunk], Cf[:, :, t0 : t0 + chunk]
        cum = torch.cumsum(da[:, :, t0 : t0 + chunk].float(), dim=-1)  # within the chunk
        L = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
        scores = (Cc @ Bc.transpose(-1, -2)) * L * dtc[..., None, :]
        ys.append(scores @ xc + (Cc * torch.exp(cum)[..., None]) @ state)
        w = torch.exp(cum[..., -1:] - cum) * dtc  # (B, H, C)
        state = (torch.exp(cum[..., -1])[..., None, None] * state
                 + Bc.transpose(-1, -2) @ (xc * w[..., None]))
    return torch.cat(ys, dim=2), state


def ssd_chunked(x, dt, A, Bm, Cm, D, init_state=None, chunk: int = 128):
    """O(S·C) chunked scan, the algorithm the ``ssd_fwd`` kernel runs."""
    if x.shape[1] % chunk:
        raise ValueError(f"seq {x.shape[1]} not divisible by chunk {chunk}")
    dtk = dt.float().transpose(1, 2)  # (B, H, S)
    y, state = chunked_scan(x.transpose(1, 2), dtk, dtk * A.float()[None, :, None],
                            Bm.transpose(1, 2), Cm.transpose(1, 2), chunk, init_state)
    y = y.transpose(1, 2) + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), state


def ssd_decode_step(x, dt, A, Bm, Cm, D, state):
    """Single-token recurrence for serving.

    x (B, H, P); dt (B, H); Bm/Cm (B, G, N); state (B, H, N, P) float32.
    Returns (y (B, H, P) in x's type, new state float32).
    """
    h = x.shape[1]
    xf, dtf = x.float(), dt.float()
    Bf = _expand_groups(Bm.float(), h, axis=1)  # (B, H, N)
    Cf = _expand_groups(Cm.float(), h, axis=1)
    decay = torch.exp(dtf * A.float())  # (B, H)
    state = decay[..., None, None] * state + torch.einsum(
        "bhn,bhp->bhnp", Bf * dtf[..., None], xf)
    y = torch.einsum("bhn,bhnp->bhp", Cf, state) + D.float()[:, None] * xf
    return y.to(x.dtype), state
