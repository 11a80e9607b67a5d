"""Plain reference per-expert SwiGLU FFN over dispatched token buffers.

The counterpart of ``repro/kernels/moe_gemm/ref.py``: x (E, Cap, Dm),
wg/wu (E, Dm, Dff), wd (E, Dff, Dm), out (E, Cap, Dm), as batched
products in the working type (the gate and up products rounded to it
before the activation, as the reference's einsums are).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["moe_ffn_ref"]


def moe_ffn_ref(x, wg, wu, wd):
    h_g = torch.bmm(x, wg)
    h_u = torch.bmm(x, wu)
    act = F.silu(h_g.float()) * h_u.float()
    return torch.bmm(act.to(x.dtype), wd)
