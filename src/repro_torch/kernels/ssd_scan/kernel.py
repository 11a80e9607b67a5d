"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper, launch count and
plain version.

``ssd_fwd`` replaces the TPU kernel of the same name in
``repro/kernels/ssd_scan/kernel.py``; its CUDA source is
``csrc/ssd_fwd.cu`` (design note there).  Kernel layout, as the Pallas
kernel's: x (B, H, S, P); dt and dA = dt * A[h] (B, H, S) float32; Bm and
Cm (B, G, S, N), head h reading group ``h // (H // G)``.  Returns y
(B, H, S, P) in x's type, without the D * x skip, and the final state
(B, H, N, P) float32.

Dispatch is by device: a CUDA tensor launches the kernel (bf16 x, Bm and
Cm; N <= 128 and P <= 64, multiples of 8; a chunk of at most 256 steps)
or raises; a CPU tensor runs the plain PyTorch version,
:func:`ssd_fwd_torch`, which is the Pallas kernel's arithmetic chunk by
chunk, in float32.  ``launches`` counts calls that launch the kernel, and
nothing else: each such call makes three CUDA launches (the source's
note): the chunks' state increments, into device scratch that the
wrapper allocates; the pass over the chunks in order, which writes each
chunk's entering state into a second such buffer, and the final state;
then y.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan.ref import chunked_scan

__all__ = ["MAX_CHUNK", "SSD_REL_L2", "SSD_STATE_REL", "launches", "ssd_fwd", "ssd_fwd_torch"]

#: Longest chunk the kernel takes (its shared-memory tiles are sized for it).
MAX_CHUNK = 256
#: The kernel against its plain version (relative L2 errors), as
#: ``chip_smoke.py`` and ``compare.py`` hold it: y is bf16 on both sides
#: (one ulp is 2**-8 relative) after float32 sums in another order, and C·Bᵀ
#: sums bf16 products on the tensor cores; the state stays float32 on both.
SSD_REL_L2 = 1e-2
SSD_STATE_REL = 1e-3
#: Kernel launches since the last reset (set to 0 to reset).
launches = {"ssd_fwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"ssd_fwd_launch": [_P] * 10 + [_I] * 7 + [_P]}


def _check(x, dt, da, Bm, Cm, chunk: int) -> int:
    """Validate the kernel layout; returns the chunk length used."""
    for name, t, nd in (("x", x, 4), ("dt", dt, 3), ("da", da, 3), ("Bm", Bm, 4), ("Cm", Cm, 4)):
        if not isinstance(t, torch.Tensor) or t.dim() != nd:
            raise ValueError(f"{name} must be a {nd}-d tensor")
    b, h, s, _ = x.shape
    g = Bm.shape[1]
    if dt.shape != (b, h, s) or da.shape != (b, h, s):
        raise ValueError(f"dt {tuple(dt.shape)} / da {tuple(da.shape)} do not fit x {tuple(x.shape)}")
    if Bm.shape != Cm.shape or Bm.shape[0] != b or Bm.shape[2] != s or h % g:
        raise ValueError(f"Bm {tuple(Bm.shape)} / Cm {tuple(Cm.shape)} do not fit x {tuple(x.shape)}")
    if len({t.device for t in (x, dt, da, Bm, Cm)}) != 1:
        raise ValueError("x, dt, da, Bm, Cm must be on one device")
    c = min(chunk, s)
    if c < 1 or s % c:
        raise ValueError(f"seq {s} not divisible by chunk {c}")
    return c


def ssd_fwd_torch(x, dt, da, Bm, Cm, *, chunk: int = 128):
    """Plain version of :func:`ssd_fwd` on any device: the Pallas kernel's
    per-chunk arithmetic in float32 (:func:`ref.chunked_scan`), every
    (b, h) at once."""
    c = _check(x, dt, da, Bm, Cm, chunk)
    y, state = chunked_scan(x, dt, da, Bm, Cm, c)
    return y.to(x.dtype), state


def ssd_fwd(
    x: torch.Tensor,  # (B, H, S, P)
    dt: torch.Tensor,  # (B, H, S) float32
    da: torch.Tensor,  # (B, H, S) float32, dt * A[h]
    Bm: torch.Tensor,  # (B, G, S, N)
    Cm: torch.Tensor,  # (B, G, S, N)
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(y (B, H, S, P) in x's type, final state (B, H, N, P) float32)."""
    c = _check(x, dt, da, Bm, Cm, chunk)
    dev = x.device
    if dev.type == "cpu":
        return ssd_fwd_torch(x, dt, da, Bm, Cm, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_fwd launches on a CUDA device; got {dev}")
    b, h, s, p = x.shape
    g, n = Bm.shape[1], Bm.shape[-1]
    for name, t, dtype in (("x", x, torch.bfloat16), ("Bm", Bm, torch.bfloat16),
                           ("Cm", Cm, torch.bfloat16), ("dt", dt, torch.float32),
                           ("da", da, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"the ssd_fwd kernel takes {name} in {dtype}; got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if n % 8 or p % 8 or n > 128 or p > 64 or c > MAX_CHUNK:
        raise ValueError(f"the ssd_fwd kernel takes N <= 128 and P <= 64 (multiples of 8) "
                         f"and a chunk <= {MAX_CHUNK}; got N={n}, P={p}, chunk={c}")
    lib = _build.library("ssd_fwd", _SIGNATURES)
    with torch.cuda.device(dev):
        y = torch.empty_like(x)
        state = torch.empty((b, h, n, p), dtype=torch.float32, device=dev)
        # scratch: each chunk's state increment and the state entering it,
        # transposed and padded to 64 x (64 or 128), and each chunk's decay
        delta, states = (torch.empty((b * h, s // c, 64, 64 if n <= 64 else 128),
                                     dtype=torch.float32, device=dev) for _ in range(2))
        decay = torch.empty((b * h, s // c), dtype=torch.float32, device=dev)
        code = lib.ssd_fwd_launch(
            x.data_ptr(), dt.data_ptr(), da.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            y.data_ptr(), state.data_ptr(), delta.data_ptr(), decay.data_ptr(),
            states.data_ptr(),
            b, h, g, s, n, p, c, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, code, "ssd_fwd_launch")
    launches["ssd_fwd"] += 1
    return y, state
