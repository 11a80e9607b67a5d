"""Numerics for the paper's theory: Q_{i,j}(l), alpha_{i,j}(N), R^N_{i,j}(d).

These implement the quantities of Theorem III.2 and Lemma III.3 exactly
(Poisson-binomial DP in float64), so tests can verify:

* the adjacent-exchange criterion ``R^N_{i,j}(i) < R^N_{i,j}(j)`` agrees
  with the sign of ``E[S*] - E[S']`` from the exact evaluator;
* ``alpha_{i,j}(N) -> 1`` as N grows (Lemma III.3) for i.i.d. success
  probabilities with ``1 < beta < inf``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.jobs import Workload, pad_workload

__all__ = [
    "poisson_binomial",
    "q_ij",
    "alpha_ij",
    "r_n",
    "beta_of",
]


def poisson_binomial(success_probs: np.ndarray) -> np.ndarray:
    """P[exactly l of the given independent Bernoullis succeed], l=0..n."""
    pmf = np.array([1.0])
    for p in success_probs:
        pmf = np.convolve(pmf, [1.0 - p, p])
    return pmf


def q_ij(jobs: Workload, i: int, j: int) -> np.ndarray:
    """Q_{i,j}(l): probability exactly l of the remaining N-2 jobs succeed."""
    _, probs, num_stages = pad_workload(jobs)
    p_succ = probs[np.arange(len(jobs)), num_stages - 1]
    others = np.delete(p_succ, [i, j])
    return poisson_binomial(others)


def alpha_ij(jobs: Workload, i: int, j: int) -> float:
    """Paper Eq. (4)."""
    n = len(jobs)
    q = q_ij(jobs, i, j)  # indices 0..N-2

    def q_at(l: int) -> float:
        return float(q[l]) if 0 <= l < len(q) else 0.0

    num = sum(q_at(l - 2) / l for l in range(2, n + 1))
    den = sum(q_at(l - 1) / l for l in range(1, n))
    return num / den


def r_n(jobs: Workload, i: int, j: int, d: int) -> float:
    """Paper Eq. (3): R^N_{i,j}(d)."""
    job = jobs[d]
    early = float(np.dot(job.sizes[:-1], job.probs[:-1]))
    return early / job.success_prob + alpha_ij(jobs, i, j) * float(job.sizes[-1])


def beta_of(success_probs: np.ndarray) -> float:
    """Empirical beta = E[p/(1-p)] (Lemma III.3's integral)."""
    p = np.asarray(success_probs, dtype=np.float64)
    return float(np.mean(p / (1.0 - p)))
