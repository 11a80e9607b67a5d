"""Learning-rate schedules (return multiplicative factors on peak lr).

The counterpart of ``repro/optim/schedule.py``.  The step is a host
integer, so the factors are computed on the host, in float32 as the
reference computes them.
"""

from __future__ import annotations

import numpy as np

__all__ = ["linear_warmup", "cosine_schedule"]


def linear_warmup(step: int, warmup_steps: int) -> float:
    return float(min(np.float32(1.0), np.float32(step + 1) / np.float32(max(warmup_steps, 1))))


def cosine_schedule(step: int, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1) -> float:
    warm = np.float32(linear_warmup(step, warmup_steps))
    t = np.clip(np.float32(step - warmup_steps) / np.float32(max(total_steps - warmup_steps, 1)),
                np.float32(0.0), np.float32(1.0))
    frac, one = np.float32(final_frac), np.float32(1)
    cos = frac + (one - frac) * np.float32(0.5) * (one + np.cos(np.float32(np.pi) * t))
    return float(warm * cos)
