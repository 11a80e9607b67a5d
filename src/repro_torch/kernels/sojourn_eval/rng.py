"""Counter-based Threefry-2x32 stream shared by every streamed-MC path.

The same generator as ``repro/kernels/sojourn_eval/rng.py`` (Salmon et
al., Random123), in three bodies that run one integer recurrence:

* :func:`threefry2x32` on NumPy ``uint32`` arrays — the host replay
  (:func:`host_uniforms`, :func:`host_outcomes`) that the tests hold
  against the reference bitwise;
* :func:`threefry2x32_torch` on ``int64`` tensors whose values stay in
  ``[0, 2**32)`` by masking with ``& 0xFFFFFFFF`` after every add and
  shift (PyTorch's CPU backend has no left shift for ``uint32``) — the
  plain version the MC kernels are checked against;
* ``csrc/threefry.cuh`` on native ``uint32_t`` inside the CUDA kernels.

Counter layout: ``x0 = sample_index``, ``x1 = job_index`` (the original
job id), keyed by the two 31-bit halves of a 62-bit seed.  The first
output word times ``2**-32`` is the per-(sample, job) uniform; an
inverse-CDF count over the per-job CDF turns it into a stop stage.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "MAX_SEED",
    "split_seed",
    "threefry2x32",
    "threefry2x32_torch",
    "uniform_from_bits",
    "host_uniforms",
    "host_outcomes",
]

#: Threefry-2x32 rotation schedule (Random123), alternating per 4-round group.
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
#: Key-schedule parity constant for Threefry-32.
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF

MAX_SEED = 1 << 62


def split_seed(seed: int) -> tuple[int, int]:
    """Split a 62-bit seed into two 31-bit key words (int32-safe)."""
    if not 0 <= seed < MAX_SEED:
        raise ValueError(f"seed must be in [0, 2**62); got {seed}")
    return seed & 0x7FFFFFFF, (seed >> 31) & 0x7FFFFFFF


def _schedule(k0: int, k1: int):
    """(rotations, (x0 key, x1 key)) for each of the five 4-round groups."""
    ks2 = k0 ^ k1 ^ _PARITY
    subkeys = ((k1, ks2), (ks2, k0), (k0, k1), (k1, ks2), (ks2, k0))
    rots = (_ROT_A, _ROT_B, _ROT_A, _ROT_B, _ROT_A)
    return zip(rots, subkeys)


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """One 20-round Threefry-2x32 block on NumPy ``uint32`` arrays."""
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
    """One 20-round Threefry-2x32 block on ``int64`` tensors in [0, 2**32).

    Every add and shift is masked back to 32 bits, so the results are
    the ``uint32`` words of :func:`threefry2x32`, held in ``int64``.
    """
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


def uniform_from_bits(bits):
    """32 random bits -> float64 uniform in [0, 1), exactly (``bits * 2**-32``)."""
    if isinstance(bits, torch.Tensor):
        return bits.to(torch.float64) * 2.0**-32
    return bits.astype(np.float64) * 2.0**-32


# ---------------------------------------------------------------------------
# Host-side replay (the oracle and parity tests ride these)
# ---------------------------------------------------------------------------


def host_uniforms(
    seed: int, sample_lo: int, n_samples: int, n_jobs: int
) -> np.ndarray:
    """(S, N) float64 uniforms for samples [sample_lo, sample_lo + S)."""
    t = np.arange(sample_lo, sample_lo + n_samples, dtype=np.int64)
    x0 = np.broadcast_to(t[:, None], (n_samples, n_jobs)).astype(np.uint32)
    x1 = np.broadcast_to(
        np.arange(n_jobs, dtype=np.int64)[None, :], (n_samples, n_jobs)
    ).astype(np.uint32)
    bits, _ = threefry2x32(split_seed(seed), x0, x1)
    return uniform_from_bits(bits)


def host_outcomes(
    seed: int, n_samples: int, probs: np.ndarray, num_stages: np.ndarray
) -> np.ndarray:
    """(S, N) int32 stop-stage outcomes: the dense replay of the stream.

    Inverse-CDF count over ``cumsum(probs)`` with the same comparison
    direction (``u >= cdf``) and clamp as the kernels, so the result is
    bitwise what the streaming evaluators decode.
    """
    probs = np.asarray(probs, dtype=np.float64)
    num_stages = np.asarray(num_stages)
    cdf = np.cumsum(probs, axis=1)  # padded stages add 0 mass
    u = host_uniforms(seed, 0, n_samples, probs.shape[0])
    outcomes = np.sum(u[:, :, None] >= cdf[None, :, :], axis=2)
    return np.minimum(outcomes, num_stages[None, :] - 1).astype(np.int32)
