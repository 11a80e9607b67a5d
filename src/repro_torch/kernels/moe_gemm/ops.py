"""Public grouped-GEMM MoE FFN op, forward only.

The counterpart of ``repro/kernels/moe_gemm/ops.py``, with the device in
place of the ``impl`` dispatch: CUDA tensors launch the ``moe_ffn_fwd``
kernel (or raise); CPU tensors run its plain version.  The backward
(recompute through :func:`ref.moe_ffn_ref`) comes with training.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.moe_gemm import kernel as K

__all__ = ["moe_ffn"]


def moe_ffn(
    x: torch.Tensor,  # (E, Cap, Dm) dispatched tokens
    wg: torch.Tensor,  # (E, Dm, Dff)
    wu: torch.Tensor,
    wd: torch.Tensor,  # (E, Dff, Dm)
) -> torch.Tensor:
    """Per-expert SwiGLU FFN; out (E, Cap, Dm) in x's type."""
    return K.moe_ffn_fwd(x, wg, wu, wd)
