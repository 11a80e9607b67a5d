"""Counter-based Threefry-2x32 (20 rounds; Salmon et al., Random123).

A frozen plain copy of the stream that the evaluator's Monte-Carlo tier
draws from, so that the reference can work out every sample's outcome
itself.  The stream's contract: the counter is ``(x0, x1) = (sample
index, job index)``; the key is the two 31-bit halves of a 62-bit seed;
the first output word times ``2**-32`` is the uniform of that (sample,
job).

Two bodies of one recurrence: :func:`threefry2x32` on NumPy ``uint32``
arrays, and :func:`threefry2x32_torch` on ``int64`` tensors whose values
stay in ``[0, 2**32)`` (masked after every add and shift).
"""

from __future__ import annotations

import numpy as np
import torch

_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF


def split_seed(seed: int) -> tuple[int, int]:
    """The two 31-bit key words of a seed in ``[0, 2**62)``."""
    if not 0 <= seed < 1 << 62:
        raise ValueError(f"seed must be in [0, 2**62); got {seed}")
    return seed & 0x7FFFFFFF, (seed >> 31) & 0x7FFFFFFF


def _schedule(k0: int, k1: int):
    ks2 = k0 ^ k1 ^ _PARITY
    subkeys = ((k1, ks2), (ks2, k0), (k0, k1), (k1, ks2), (ks2, k0))
    rots = (_ROT_A, _ROT_B, _ROT_A, _ROT_B, _ROT_A)
    return zip(rots, subkeys)


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """One block on NumPy ``uint32`` arrays; returns both output words."""
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    u32 = np.uint32
    x0 = x0.astype(u32) + u32(k0)
    x1 = x1.astype(u32) + u32(k1)
    for i, (rot4, (ka, kb)) in enumerate(_schedule(k0, k1)):
        for r in rot4:
            x0 = x0 + x1
            x1 = (x1 << u32(r)) | (x1 >> u32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + u32(ka)
        x1 = (x1 + u32(kb)) + u32(i + 1)
    return x0, x1


def threefry2x32_torch(key: tuple[int, int], x0: torch.Tensor, x1: torch.Tensor):
    """One block on ``int64`` tensors in ``[0, 2**32)``: the ``uint32``
    words of :func:`threefry2x32`, held in ``int64``."""
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    x0 = (x0.to(torch.int64) + k0) & _MASK
    x1 = (x1.to(torch.int64) + k1) & _MASK
    for i, (rot4, (ka, kb)) in enumerate(_schedule(k0, k1)):
        for r in rot4:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) & _MASK) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ka) & _MASK
        x1 = (x1 + kb + i + 1) & _MASK
    return x0, x1
