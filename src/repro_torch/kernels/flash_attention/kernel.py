"""FlashAttention forward and backward: the CUDA kernels' wrappers, launch
counts and plain versions.

``flash_fwd``, ``flash_dkv`` and ``flash_dq`` replace the TPU kernels of
the same names in ``repro/kernels/flash_attention/kernel.py``; their CUDA
sources are ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (design notes
there), all three on TMA, an mbarrier ring and wgmma, whose pieces are in
``csrc/hopper.cuh``.  Layout (B, H, S, D); GQA by
head index (query head h reads KV head ``h // (Hq // Hkv)``); causal and
sliding-window masking (key j visible to query i iff ``j <= i`` and
``j > i - window``); returns O in the input type and the float32
log-sum-exp (B, Hq, Sq).

Dispatch is by device: a CUDA tensor launches the kernel (bf16, head dim
16, 32, 64, 112 or 128: every registered config, SMOKE included) or
raises; a CPU
tensor runs the plain PyTorch version, :func:`flash_fwd_torch`, which
walks the forward kernel's (FWD_BLOCK_Q, FWD_BLOCK_K) tiles with the same
online softmax, block skipping and NEG_INF / 1e-30 conventions, so the
two agree even on a row that sees no key.  ``launches`` counts kernel
launches and nothing else.

The backward takes the forward's LSE and ``delta = rowsum(dO * O)``
(B, Hq, Sq) float32 and returns float32 gradients, as the Pallas kernels
do: ``flash_dkv`` gives dK, dV (B, Hkv, Skv, D), summed over the query
heads of each KV head's group, and ``flash_dq`` gives dQ (B, Hq, Sq, D).
Each kernel skips whole blocks at its own tiles: ``flash_dkv`` walks
query tiles of DKV_BLOCK_Q = 64 rows against a CTA's DKV_BLOCK_K = 128
keys, ``flash_dq`` key tiles of DQ_BLOCK_K = 64 against a CTA's
DQ_BLOCK_Q = 128 rows.  Their plain versions, :func:`flash_dkv_torch`
and :func:`flash_dq_torch`, walk the same blocks with the same skipping
(which decides the rows that see no key) and keep P and dS in float32,
as the Pallas bodies write them; the kernels round P and dS to bf16
before their tensor-core products.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["FWD_BLOCK_Q", "FWD_BLOCK_K", "DKV_BLOCK_Q", "DKV_BLOCK_K", "DQ_BLOCK_Q",
           "DQ_BLOCK_K", "NEG_INF", "launches",
           "flash_fwd", "flash_fwd_torch", "flash_dkv", "flash_dkv_torch", "flash_dq",
           "flash_dq_torch"]

#: Query rows of a forward CTA and keys of its tiles (``kBQ`` / ``kBK`` in
#: flash_fwd.cu).
FWD_BLOCK_Q = 128
FWD_BLOCK_K = 128
#: flash_dkv's blocks: query rows of its tiles and keys of a CTA
#: (``kDkvBQ`` / ``kDkvBK`` in flash_bwd.cu).
DKV_BLOCK_Q = 64
DKV_BLOCK_K = 128
#: flash_dq's blocks: query rows of a CTA and keys of its tiles
#: (``kDqBQ`` / ``kDqBK``).
DQ_BLOCK_Q = 128
DQ_BLOCK_K = 64
#: Large-but-finite mask value: avoids NaN from (-inf) - (-inf).
NEG_INF = -1e30
#: Head dims the kernels are compiled for.
KERNEL_HEAD_DIMS = (16, 32, 64, 112, 128)
#: Kernel launches since the last reset (set to 0 to reset).
launches = {"flash_fwd": 0, "flash_dkv": 0, "flash_dq": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "flash_fwd_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,
                         _I, _I, _P],
}
_BWD_SIGNATURES = {
    "flash_dkv_launch": [_P] * 8 + [_I] * 6 + [ctypes.c_float] + [_I] * 3 + [_P],
    "flash_dq_launch": [_P] * 7 + [_I] * 6 + [ctypes.c_float] + [_I] * 3 + [_P],
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


def _visible_blocks(sq: int, k0: int, k1: int, causal: bool, window: int | None, dev,
                    block_q: int):
    """(Sq,) bool: whether the ``block_q``-row query block of each row can
    see any pair of keys [k0, k1): the kernels' block-level skip."""
    q_start = torch.arange(sq, device=dev) // block_q * block_q
    q_end = torch.clamp(q_start + block_q, max=sq) - 1
    visible = torch.ones(sq, dtype=torch.bool, device=dev)
    if causal:
        visible &= k0 <= q_end
    if window is not None:
        visible &= (k1 - 1) > q_start - window
    return visible


def _masked_scores(qf, kb, k0: int, scale: float, causal: bool, window: int | None):
    """Q Kᵀ * scale (B, Hkv, G, Sq, kb rows) of float32 queries (B, Hkv, G,
    Sq, D) against the key block kb (B, Hkv, rows, D) starting at key k0,
    with invisible pairs set to NEG_INF."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb.float()) * scale
    if causal or window is not None:
        sq, dev = qf.shape[3], qf.device
        q_ids = torch.arange(sq, device=dev)[:, None]
        k_ids = torch.arange(k0, k0 + kb.shape[2], device=dev)[None, :]
        pair = torch.ones((sq, kb.shape[2]), dtype=torch.bool, device=dev)
        if causal:
            pair &= k_ids <= q_ids
        if window is not None:
            pair &= k_ids > q_ids - window
        s = torch.where(pair, s, NEG_INF)
    return s


def flash_fwd_torch(q, k, v, *, scale: float, causal: bool, window: int | None):
    """Plain version of :func:`flash_fwd` on any device: the kernel's tile
    walk (FWD_BLOCK_Q query rows, FWD_BLOCK_K keys), with every query block
    of a key block at once."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    qf = q.float().reshape(b, hkv, g, sq, d)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=dev)
    for k0 in range(0, skv, FWD_BLOCK_K):
        k1 = min(k0 + FWD_BLOCK_K, skv)
        visible_block = _visible_blocks(sq, k0, k1, causal, window, dev, FWD_BLOCK_Q)
        if not bool(visible_block.any()):
            continue
        s = _masked_scores(qf, k[:, :, k0:k1], k0, scale, causal, window)
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


def _backward_blocks(q, k, v, do, lse, delta, scale, causal, window, block_q, block_k):
    """The plain backward's walk over ``block_k``-key blocks: yields ``(k0,
    k1, P, dS, Q, dO)``, P and dS float32 (B, Hkv, G, Sq, k1 - k0) and 0 on
    the rows whose ``block_q``-row query block the kernel skips, Q and dO
    float32 (B, Hkv, G, Sq, D)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, sq, d)
    dof = do.float().reshape(b, hkv, g, sq, d)
    lse_ = lse.float().reshape(b, hkv, g, sq, 1)
    delta_ = delta.float().reshape(b, hkv, g, sq, 1)
    for k0 in range(0, skv, block_k):
        k1 = min(k0 + block_k, skv)
        visible_block = _visible_blocks(sq, k0, k1, causal, window, q.device, block_q)
        if not bool(visible_block.any()):
            continue
        s = _masked_scores(qf, k[:, :, k0:k1], k0, scale, causal, window)
        p = torch.where(visible_block[:, None], torch.exp(s - lse_), 0.0)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, v[:, :, k0:k1].float())
        yield k0, k1, p, p * (dp - delta_), qf, dof


def flash_dkv_torch(q, k, v, do, lse, delta, *, scale: float, causal: bool,
                    window: int | None):
    """Plain version of :func:`flash_dkv` on any device: dV = Pᵀ dO and
    dK = scale * dSᵀ Q per DKV_BLOCK_K-key block, its DKV_BLOCK_Q-row query
    tiles skipped as the kernel skips them, P and dS in float32."""
    b, hkv, skv, d = k.shape
    dk = torch.zeros((b, hkv, skv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for k0, k1, p, ds, qf, dof in _backward_blocks(q, k, v, do, lse, delta, scale, causal,
                                                   window, DKV_BLOCK_Q, DKV_BLOCK_K):
        dv[:, :, k0:k1] = torch.einsum("bhgqk,bhgqd->bhkd", p, dof)
        dk[:, :, k0:k1] = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    return dk, dv


def flash_dq_torch(q, k, v, do, lse, delta, *, scale: float, causal: bool,
                   window: int | None):
    """Plain version of :func:`flash_dq` on any device: dQ = scale * Σ dS K
    over the DQ_BLOCK_K-key tiles that each DQ_BLOCK_Q-row block sees, P
    and dS in float32."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    dq = torch.zeros((b, hkv, hq // hkv, sq, d), dtype=torch.float32, device=q.device)
    for k0, k1, _, ds, _, _ in _backward_blocks(q, k, v, do, lse, delta, scale, causal, window,
                                                DQ_BLOCK_Q, DQ_BLOCK_K):
        dq += torch.einsum("bhgqk,bhkd->bhgqd", ds, k[:, :, k0:k1].float())
    return (dq * scale).reshape(b, hq, sq, d)


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
    _kernel_args("flash_fwd", {"q": q, "k": k, "v": v})
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
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


def _check_backward(q, k, v, do, lse, delta):
    _check(q, k, v)
    b, hq, sq, _ = q.shape
    if do.shape != q.shape or do.device != q.device or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} does not fit q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, hq, sq) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be float32 (B, Hq, Sq) = {(b, hq, sq)} on {q.device}")


def _kernel_args(name: str, tensors: dict) -> None:
    """Raise unless the (B, H, S, D) tensors and the float32 rows can go to
    the CUDA kernel ``name``."""
    q = tensors["q"]
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the {name} kernel takes bfloat16; got {q.dtype}")
    if q.shape[3] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the {name} kernel takes head dim {KERNEL_HEAD_DIMS}; got {q.shape[3]}")
    for key, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{key} must be contiguous and 16-byte aligned")


def flash_dkv(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, D)
    do: torch.Tensor,  # (B, Hq, Sq, D), dL/dO
    lse: torch.Tensor,  # (B, Hq, Sq) float32, the forward's
    delta: torch.Tensor,  # (B, Hq, Sq) float32, rowsum(dO * O)
    *,
    scale: float,
    causal: bool,
    window: int | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV), each (B, Hkv, Skv, D) float32."""
    _check_backward(q, k, v, do, lse, delta)
    dev = q.device
    if dev.type == "cpu":
        return flash_dkv_torch(q, k, v, do, lse, delta, scale=scale, causal=causal,
                               window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_dkv launches on a CUDA device; got {dev}")
    _kernel_args("flash_dkv", {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta})
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    lib = _build.library("flash_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(dev):
        dk = torch.empty((b, hkv, skv, d), dtype=torch.float32, device=dev)
        dv = torch.empty_like(dk)
        code = lib.flash_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq, hkv, sq, skv, d,
            float(scale), int(causal), int(window is not None), int(window or 0),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, code, "flash_dkv_launch")
    launches["flash_dkv"] += 1
    return dk, dv


def flash_dq(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Skv, D)
    v: torch.Tensor,  # (B, Hkv, Skv, D)
    do: torch.Tensor,  # (B, Hq, Sq, D), dL/dO
    lse: torch.Tensor,  # (B, Hq, Sq) float32, the forward's
    delta: torch.Tensor,  # (B, Hq, Sq) float32, rowsum(dO * O)
    *,
    scale: float,
    causal: bool,
    window: int | None,
) -> torch.Tensor:
    """dQ (B, Hq, Sq, D) float32."""
    _check_backward(q, k, v, do, lse, delta)
    dev = q.device
    if dev.type == "cpu":
        return flash_dq_torch(q, k, v, do, lse, delta, scale=scale, causal=causal,
                              window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_dq launches on a CUDA device; got {dev}")
    _kernel_args("flash_dq", {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta})
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    lib = _build.library("flash_bwd", _BWD_SIGNATURES)
    with torch.cuda.device(dev):
        dq = torch.empty((b, hq, sq, d), dtype=torch.float32, device=dev)
        code = lib.flash_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), b, hq, hkv, sq, skv, d, float(scale),
            int(causal), int(window is not None), int(window or 0),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, code, "flash_dq_launch")
    launches["flash_dq"] += 1
    return dq
