"""OPTIMAL: the least expected sojourn time of successful jobs over all N!
orders of whole jobs, served with no preemption (the paper's Theorem
III.1: on one server an optimal schedule does not preempt)."""

import itertools
import math

import numpy as np

KIND = "optimum"


def plan(sizes, probs, rng):
    return np.array(list(itertools.permutations(range(sizes.shape[0]))), dtype=np.int64)


def evaluations(n_jobs: int) -> int:
    """Orders that one evaluation of a group of ``n_jobs`` runs."""
    return math.factorial(n_jobs)
