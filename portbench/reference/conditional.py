"""A job as seen after surviving ``s`` checkpoints: its remaining sizes
and conditional stop probabilities (the clamp keeps a survival mass that
rounds to 0 or below finite, at the remaining mass)."""

import numpy as np


def conditional(sizes, probs, s):
    """(remaining sizes (N, M - s), conditional probabilities (N, M - s))."""
    surv = 1.0 - probs[:, :s].sum(axis=1)
    tail = np.maximum(probs[:, s:].sum(axis=1), np.finfo(probs.dtype).tiny)
    surv = np.where(surv <= 0.0, tail, surv)
    base = sizes[:, s - 1] if s > 0 else np.zeros_like(sizes[:, 0])
    return sizes[:, s:] - base[:, None], probs[:, s:] / surv[:, None]
