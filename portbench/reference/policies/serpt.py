"""SERPT, stage by stage: a job's index after ``s`` checkpoints is its
expected remaining processing time."""

import numpy as np

from portbench.reference.conditional import conditional

KIND = "index"


def plan(sizes, probs, rng):
    table = np.empty_like(sizes)
    for s in range(sizes.shape[1]):
        rem, q = conditional(sizes, probs, s)
        table[:, s] = (rem * q).sum(axis=1)
    return table
