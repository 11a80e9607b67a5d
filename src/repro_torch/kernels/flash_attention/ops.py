"""Public fused-attention op, forward only.

The counterpart of ``repro/kernels/flash_attention/ops.py``, with the
device in place of the ``impl`` dispatch: CUDA tensors launch the
``flash_fwd`` kernel (or raise); CPU tensors run its plain version.  The
public face keeps the models' (B, S, H, D) layout; the kernel's is
(B, H, S, D), so q, k and v are transposed into contiguous copies and O
back.  A ``torch.autograd.Function`` with the backward kernels comes
with training.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as K

__all__ = ["flash_attention"]


def _to_kernel(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> contiguous (B, H, S, D)."""
    return x.transpose(1, 2).contiguous()


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Fused multi-head attention; O (B, Sq, Hq, D) in q's type."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    o, _ = K.flash_fwd(_to_kernel(q), _to_kernel(k), _to_kernel(v), scale=scale,
                       causal=causal, window=window)
    return o.transpose(1, 2)
