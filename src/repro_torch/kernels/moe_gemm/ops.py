"""Public grouped-GEMM MoE FFN op with its backward.

The counterpart of ``repro/kernels/moe_gemm/ops.py``, with the device in
place of the ``impl`` dispatch: CUDA tensors launch the ``moe_ffn_fwd``
kernel (or raise); CPU tensors run its plain version.  ``_MoeFFN`` is the
counterpart of ``_moe_pallas`` with ``_moe_fwd`` / ``_moe_bwd``
(``ops.py:31-44`` there): the forward runs the kernel and saves its
inputs; the backward recomputes through the oracle
:func:`ref.moe_ffn_ref` under autograd, as the reference takes the VJP
of its oracle.  The reference has no backward kernel, and neither has
the port: the backward is three more batched products per input.  The
oracle rounds the gate and up products to the working type before the
activation (ROADMAP R5), in the backward exactly as in the reference's.

``meta`` tensors (the dry run) take the oracle, for its shapes.  Under a
mesh the op never sees a DTensor: :func:`repro_torch.models.moe.moe_apply`
calls it on each rank's local shard.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.moe_gemm import kernel as K
from repro_torch.kernels.moe_gemm.ref import moe_ffn_ref

__all__ = ["moe_ffn"]


class _MoeFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wg, wu, wd):
        ctx.save_for_backward(x, wg, wu, wd)
        return K.moe_ffn_fwd(x, wg, wu, wd)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = moe_ffn_ref(*inputs)
        return torch.autograd.grad(out, inputs, g)


def moe_ffn(
    x: torch.Tensor,  # (E, Cap, Dm) dispatched tokens
    wg: torch.Tensor,  # (E, Dm, Dff)
    wu: torch.Tensor,
    wd: torch.Tensor,  # (E, Dff, Dm)
) -> torch.Tensor:
    """Per-expert SwiGLU FFN; out (E, Cap, Dm) in x's type, differentiable
    in every input."""
    if x.device.type == "meta":
        return moe_ffn_ref(x, wg, wu, wd)
    return _MoeFFN.apply(x, wg, wu, wd)

