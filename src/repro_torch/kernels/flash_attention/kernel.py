"""FlashAttention forward: the CUDA kernel's wrapper, launch count and
plain version.

``flash_fwd`` replaces the TPU kernel of the same name in
``repro/kernels/flash_attention/kernel.py``; its CUDA source is
``csrc/flash_fwd.cu`` (design note there).  Layout (B, H, S, D); GQA by
head index (query head h reads KV head ``h // (Hq // Hkv)``); causal and
sliding-window masking (key j visible to query i iff ``j <= i`` and
``j > i - window``); returns O in the input type and the float32
log-sum-exp (B, Hq, Sq).

Dispatch is by device: a CUDA tensor launches the kernel (bf16, head dim
64 or 128) or raises; a CPU tensor runs the plain PyTorch version,
:func:`flash_fwd_torch`, which walks the same (BLOCK_Q, BLOCK_K) tiles
with the same online softmax, block skipping and NEG_INF / 1e-30
conventions, so the two agree even on a row that sees no key.
``launches`` counts kernel launches and nothing else.  The backward
kernels (``flash_dkv``, ``flash_dq``) come with training.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["BLOCK_Q", "BLOCK_K", "NEG_INF", "launches", "flash_fwd", "flash_fwd_torch"]

#: Query rows and keys of a tile (``kBQ`` / ``kBK`` in the source).
BLOCK_Q = 64
BLOCK_K = 64
#: Large-but-finite mask value: avoids NaN from (-inf) - (-inf).
NEG_INF = -1e30
#: Head dims the kernel is compiled for.
KERNEL_HEAD_DIMS = (64, 128)
#: Kernel launches since the last reset (set to 0 to reset).
launches = {"flash_fwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_fwd_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,
                         _I, _I, _P],
}


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-d (B, H, S, D) tensor")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={k.shape[1]}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v of {q.dtype}, {k.dtype}, {v.dtype}")


def flash_fwd_torch(q, k, v, *, scale: float, causal: bool, window: int | None):
    """Plain version of :func:`flash_fwd` on any device: the kernel's tile
    walk, with every query block of a key block at once."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    qf = q.float().reshape(b, hkv, g, sq, d)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    q_ids = torch.arange(sq, device=dev)
    q_start = q_ids // BLOCK_Q * BLOCK_Q  # each row's query block
    q_end = torch.clamp(q_start + BLOCK_Q, max=sq) - 1
    for k0 in range(0, skv, BLOCK_K):
        k1 = min(k0 + BLOCK_K, skv)
        visible_block = torch.ones(sq, dtype=torch.bool, device=dev)
        if causal:
            visible_block &= k0 <= q_end
        if window is not None:
            visible_block &= (k1 - 1) > q_start - window
        if not bool(visible_block.any()):
            continue
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k[:, :, k0:k1].float()) * scale
        if causal or window is not None:
            k_ids = torch.arange(k0, k1, device=dev)[None, :]
            pair = torch.ones((sq, k1 - k0), dtype=torch.bool, device=dev)
            if causal:
                pair &= k_ids <= q_ids[:, None]
            if window is not None:
                pair &= k_ids > q_ids[:, None] - window
            s = torch.where(pair, s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v[:, :, k0:k1].float())
        m = torch.where(visible_block, m_cur, m)
        l = torch.where(visible_block, l * alpha + p.sum(dim=-1), l)
        acc = torch.where(visible_block[:, None], acc * alpha[..., None] + pv, acc)
    den = l.clamp(min=1e-30)
    o = (acc / den[..., None]).to(q.dtype).reshape(b, hq, sq, d)
    return o, (m + torch.log(den)).reshape(b, hq, sq)


def flash_fwd(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, D)
    *,
    scale: float,
    causal: bool,
    window: int | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(O (B, Hq, Sq, D) in q's type, LSE (B, Hq, Sq) float32)."""
    _check(q, k, v)
    dev = q.device
    if dev.type == "cpu":
        return flash_fwd_torch(q, k, v, scale=scale, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_fwd launches on a CUDA device; got {dev}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the flash_fwd kernel takes bfloat16; got {q.dtype}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash_fwd kernel takes head dim {KERNEL_HEAD_DIMS}; got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    lib = _build.library("flash_fwd", _SIGNATURES)
    with torch.cuda.device(dev):
        o = torch.empty_like(q)
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
        code = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            b, hq, hkv, sq, skv, d, float(scale), int(causal), int(window is not None),
            int(window or 0), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, code, "flash_fwd_launch")
    launches["flash_fwd"] += 1
    return o, lse
