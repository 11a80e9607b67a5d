"""Plain reference attention (the oracle, and the decode path).

The counterpart of ``repro/kernels/flash_attention/ref.py``.  Layout (as
the models): q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D) with Hq a multiple
of Hkv (GQA).  Scores and softmax in float32 whatever the input type; P
is cast to V's type before the PV product, as the kernel does; the
output is cast back to q's type.

Masking supports ``causal`` and a sliding window of size ``window`` (key
j visible to query i iff i - window < j <= i), an optional ``kv_len``
for decode against a padded cache (keys at positions >= kv_len are
masked) and a ``q_offset`` (the absolute position of query 0).
"""

from __future__ import annotations

import torch

__all__ = ["ref_attention"]


def _mask_bias(sq: int, skv: int, causal: bool, window: int | None, kv_len=None,
               q_offset=None, device=None) -> torch.Tensor:
    """(Sq, Skv) additive bias in f32: 0 where visible, -inf where masked."""
    q_idx = torch.arange(sq, device=device)[:, None]
    if q_offset is not None:
        q_idx = q_idx + q_offset  # decode: absolute query position
    k_idx = torch.arange(skv, device=device)[None, :]
    visible = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        visible &= k_idx <= q_idx
    if window is not None:
        visible &= k_idx > q_idx - window
    if kv_len is not None:
        visible &= k_idx < kv_len
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(visible, zero, -torch.inf)


def ref_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    kv_len=None,
    q_offset=None,
) -> torch.Tensor:
    """O(Sq*Skv) softmax attention with GQA head broadcasting."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    g = hq // hkv
    if scale is None:
        scale = d**-0.5
    # A bf16 x bf16 product is exact in float32, so the float32 copies give
    # the reference's dot(bf16, bf16 -> f32) up to the order of the sums.
    qg = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale  # (B, Hkv, G, Sq, Skv)
    s = s + _mask_bias(sq, skv, causal, window, kv_len, q_offset, q.device)
    # Guard all-masked rows (possible when kv_len == 0): softmax of a -inf row.
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)
