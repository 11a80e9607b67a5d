"""SR (the paper's Eq. 2), stage by stage: a job's index after ``s``
checkpoints is ``min_j [sum_{k<=j} x_k q_k + x_j (1 - sum_{k<=j} q_k)] /
sum_{k<=j} q_k`` over its remaining sizes ``x`` and conditional stop
probabilities ``q``."""

import numpy as np

from portbench.reference.conditional import conditional

KIND = "index"


def plan(sizes, probs, rng):
    table = np.empty_like(sizes)
    for s in range(sizes.shape[1]):
        rem, q = conditional(sizes, probs, s)
        cum_q = np.cumsum(q, axis=1)
        num = np.cumsum(rem * q, axis=1) + rem * (1.0 - cum_q)
        table[:, s] = (num / np.maximum(cum_q, 1e-300)).min(axis=1)
    return table
