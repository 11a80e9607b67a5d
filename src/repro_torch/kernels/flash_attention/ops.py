"""Public fused-attention op with its backward.

The counterpart of ``repro/kernels/flash_attention/ops.py``, with the
device in place of the ``impl`` dispatch: CUDA tensors launch the
``flash_fwd``, ``flash_dkv`` and ``flash_dq`` kernels (or raise); CPU
tensors run their plain versions.  ``_FlashAttention`` is the
counterpart of ``_flash_pallas`` with ``_flash_fwd_rule`` and
``_flash_bwd_rule`` (``ops.py:43-75`` there): the forward saves q, k, v,
O and the LSE; the backward forms ``delta = rowsum(dO * O)`` in float32
(plain PyTorch, as the reference computes it outside any kernel), then
runs ``flash_dkv`` and ``flash_dq`` and casts the float32 gradients to
the input types.  The public face keeps the models' (B, S, H, D) layout;
the kernels' is (B, H, S, D), so q, k and v are transposed into
contiguous copies and O back, and autograd carries the gradients through
the same transposes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as K

__all__ = ["flash_attention"]


def _to_kernel(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> contiguous (B, H, S, D)."""
    return x.transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):
    """O = attention(q, k, v) in the kernels' (B, H, S, D) layout."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool, window: int | None):
        o, lse = K.flash_fwd(q, k, v, scale=scale, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = {"scale": scale, "causal": causal, "window": window}
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dk, dv = K.flash_dkv(q, k, v, do, lse, delta, **ctx.args)
        dq = K.flash_dq(q, k, v, do, lse, delta, **ctx.args)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Fused multi-head attention; O (B, Sq, Hq, D) in q's type,
    differentiable in q, k and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    o = _FlashAttention.apply(_to_kernel(q), _to_kernel(k), _to_kernel(v), scale, causal,
                              window)
    return o.transpose(1, 2)
