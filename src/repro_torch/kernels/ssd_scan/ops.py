"""Public SSD op, forward only.

The counterpart of ``repro/kernels/ssd_scan/ops.py``, with the device in
place of the ``impl`` dispatch: CUDA tensors launch the ``ssd_fwd``
kernel (or raise); CPU tensors run its plain version.  The public face
keeps the models' layout (B, S, H, P); this module transposes into the
kernel's (B, H, S, P), forms ``dA = dt * A``, and adds the ``D * x`` skip
in the working type after the kernel's y, as ``_ssd_pallas_fwd`` does
(``ops.py:37-47``), so the numbers are those the TPU path computes.  The
backward (recompute through :func:`ref.ssd_chunked`) comes with training.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import kernel as K

__all__ = ["ssd_scan"]


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H), softplus-ed, > 0
    A: torch.Tensor,  # (H,), negative
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    D: torch.Tensor,  # (H,)
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan; returns (y (B, S, H, P) in x's type, final state
    (B, H, N, P) float32)."""
    xk = x.transpose(1, 2).contiguous()  # (B, H, S, P)
    dtk = dt.transpose(1, 2).contiguous()  # (B, H, S)
    dak = dtk * A[None, :, None].to(dtk.dtype)
    Bk = Bm.transpose(1, 2).contiguous()  # (B, G, S, N)
    Ck = Cm.transpose(1, 2).contiguous()
    y, state = K.ssd_fwd(xk, dtk, dak, Bk, Ck, chunk=chunk)
    y = y.transpose(1, 2) + (D[None, None, :, None] * x).to(y.dtype)
    return y.to(x.dtype), state
