"""Job model for multi-stage jobs with early termination.

A job i has M_i possible (cumulative) sizes 0 < x_{i,1} < ... < x_{i,M_i}
and termination probabilities p_{i,j} summing to 1.  Reaching size
x_{i,M_i} means the job completed *successfully*; stopping at any earlier
checkpoint x_{i,j}, j < M_i, is an early termination (unsuccessful).

This module is the port's data layer, shared by the evaluator
(:mod:`repro_torch.core.evaluator`) and the policies
(:mod:`repro_torch.core.policies`).  It is the same NumPy code as
``repro/core/jobs.py``, so an identical ``np.random.Generator`` gives
identical arrays; :func:`from_reference` carries a workload built by the
JAX package across without importing it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "JobSpec",
    "Workload",
    "from_reference",
    "pad_workload",
    "generate_workload",
    "WORKLOAD_SETS",
    "sample_success_probs",
    "sample_stage_sizes",
]


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """A single multi-stage job.

    Attributes:
      sizes: (M,) ascending cumulative checkpoint sizes; ``sizes[-1]`` is the
        full (successful) duration.
      probs: (M,) termination probabilities at each checkpoint; sum to 1.
        ``probs[-1]`` is the success probability.
      arrival: arrival time (0 for the static single-server problem).
      job_id: stable external identifier.
      outcome_stage: optional *realized* outcome (index into sizes) used by
        trace-driven simulation, where the ground truth is known but hidden
        from the scheduler.  -1 = sample at run time.
    """

    sizes: np.ndarray
    probs: np.ndarray
    arrival: float = 0.0
    job_id: int = -1
    outcome_stage: int = -1

    def __post_init__(self):
        sizes = np.asarray(self.sizes, dtype=np.float64)
        probs = np.asarray(self.probs, dtype=np.float64)
        object.__setattr__(self, "sizes", sizes)
        object.__setattr__(self, "probs", probs)
        if sizes.ndim != 1 or probs.shape != sizes.shape:
            raise ValueError("sizes/probs must be 1-D and same shape")
        if not np.all(np.diff(sizes) > 0):
            raise ValueError("sizes must be strictly ascending")
        if sizes[0] <= 0:
            raise ValueError("sizes must be positive")
        if np.any(probs < 0) or abs(probs.sum() - 1.0) > 1e-9:
            raise ValueError("probs must be a distribution")

    # -- derived quantities (Section II / III of the paper) ---------------

    @property
    def num_stages(self) -> int:
        return int(self.sizes.shape[0])

    @property
    def success_prob(self) -> float:
        """p_{i,M_i}."""
        return float(self.probs[-1])

    @property
    def erpt(self) -> float:
        """Expected (total) processing time  E[size] = sum_j x_j p_j."""
        return float(np.dot(self.sizes, self.probs))

    @property
    def rank(self) -> float:
        """Paper Eq. (23):  R(i) = E[size] / p_success."""
        return self.erpt / self.success_prob

    def stage_increments(self) -> np.ndarray:
        """Per-stage service increments delta_j = x_j - x_{j-1}."""
        return np.diff(self.sizes, prepend=0.0)

    def conditional(self, stages_done: int) -> "JobSpec":
        """Job as seen after surviving ``stages_done`` checkpoints.

        Remaining sizes are re-based at the current service point and
        probabilities renormalized; used by dynamic (stage-level) policies.
        """
        s = stages_done
        if not 0 <= s < self.num_stages:
            raise ValueError(f"stages_done={s} out of range")
        if s == 0:
            return self
        surv = 1.0 - self.probs[:s].sum()
        if surv <= 0:
            raise ValueError("job cannot have survived these stages")
        return JobSpec(
            sizes=self.sizes[s:] - self.sizes[s - 1],
            probs=self.probs[s:] / surv,
            arrival=self.arrival,
            job_id=self.job_id,
            outcome_stage=max(self.outcome_stage - s, -1)
            if self.outcome_stage >= 0
            else -1,
        )


Workload = Sequence[JobSpec]


def pad_workload(jobs: Workload) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad a workload to rectangular (N, M_max) arrays.

    Returns ``(sizes, probs, num_stages)`` where padded stage entries carry
    probability 0 and repeat the last size (so cumulative-size gathers stay
    well-defined).
    """
    n = len(jobs)
    m = max(j.num_stages for j in jobs)
    sizes = np.zeros((n, m), dtype=np.float64)
    probs = np.zeros((n, m), dtype=np.float64)
    num_stages = np.zeros((n,), dtype=np.int64)
    for i, j in enumerate(jobs):
        k = j.num_stages
        sizes[i, :k] = j.sizes
        sizes[i, k:] = j.sizes[-1]
        probs[i, :k] = j.probs
        num_stages[i] = k
    return sizes, probs, num_stages


# ---------------------------------------------------------------------------
# Workload generators (paper Section IV-A2, Table III)
# ---------------------------------------------------------------------------

#: Final-success-probability distribution I (paper Table I).
DIST_I_VALUES = np.arange(0.1, 1.0, 0.1)
DIST_I_PROBS = np.array([0.2, 0.15, 0.1, 0.05, 0.0, 0.05, 0.1, 0.15, 0.2])

#: Final-success-probability distribution II (paper Table II).
DIST_II_VALUES = np.arange(0.1, 1.0, 0.1)
DIST_II_PROBS = np.array([0.025, 0.05, 0.1, 0.15, 0.35, 0.15, 0.1, 0.05, 0.025])


def sample_success_probs(rng: np.random.Generator, n: int, kind: str) -> np.ndarray:
    """Sample final success probabilities p_{i,M_i}."""
    if kind == "uniform":
        return rng.uniform(1e-5, 1 - 1e-5, size=n)
    if kind == "dist1":
        return rng.choice(DIST_I_VALUES, size=n, p=DIST_I_PROBS / DIST_I_PROBS.sum())
    if kind == "dist2":
        return rng.choice(DIST_II_VALUES, size=n, p=DIST_II_PROBS / DIST_II_PROBS.sum())
    raise ValueError(f"unknown success-prob distribution {kind!r}")


def sample_stage_sizes(
    rng: np.random.Generator, n: int, m: int, kind: str
) -> np.ndarray:
    """Sample per-stage *increments*, returned as cumulative sizes (n, m)."""
    if kind == "uniform":
        inc = rng.uniform(0.0, 1.0, size=(n, m))
    elif kind == "exp":
        inc = rng.exponential(1.0, size=(n, m))
    elif kind == "weibull":
        # heavy tail: shape 0.5 as in the paper
        inc = rng.weibull(0.5, size=(n, m))
    else:
        raise ValueError(f"unknown stage-size distribution {kind!r}")
    inc = np.maximum(inc, 1e-9)  # sizes must be strictly ascending
    return np.cumsum(inc, axis=1)


#: Paper Table III: (stage-size dist, success-prob dist) per workload set.
WORKLOAD_SETS = {
    1: ("uniform", "uniform"),
    2: ("uniform", "dist1"),
    3: ("uniform", "dist2"),
    4: ("exp", "uniform"),
    5: ("weibull", "uniform"),
}


def generate_workload(
    rng: np.random.Generator,
    n_jobs: int,
    num_stages: int = 2,
    workload_set: int = 1,
    arrivals: np.ndarray | None = None,
) -> list[JobSpec]:
    """Generate one trial's job group per the paper's Section IV-A2.

    Final success probability is drawn from the set's distribution; the
    remaining mass ``1 - p_M`` is split over the M-1 early checkpoints with
    a symmetric Dirichlet (the paper does not pin this down for M > 2; for
    the paper's default M=2 it is exactly ``p_1 = 1 - p_2``).
    """
    size_kind, prob_kind = WORKLOAD_SETS[workload_set]
    sizes = sample_stage_sizes(rng, n_jobs, num_stages, size_kind)
    p_final = sample_success_probs(rng, n_jobs, prob_kind)
    jobs = []
    for i in range(n_jobs):
        if num_stages == 1:
            probs = np.array([1.0])
        elif num_stages == 2:
            probs = np.array([1.0 - p_final[i], p_final[i]])
        else:
            w = rng.dirichlet(np.ones(num_stages - 1))
            probs = np.concatenate([(1.0 - p_final[i]) * w, [p_final[i]]])
        jobs.append(
            JobSpec(
                sizes=sizes[i],
                probs=probs,
                arrival=0.0 if arrivals is None else float(arrivals[i]),
                job_id=i,
            )
        )
    return jobs


def from_reference(jobs) -> list[JobSpec]:
    """Convert any job objects with ``.sizes/.probs/.arrival/.job_id/
    .outcome_stage`` (the JAX package's ``JobSpec``s) into this package's
    :class:`JobSpec`, by duck typing: nothing of the other package is
    imported."""
    return [
        JobSpec(
            sizes=np.array(j.sizes, dtype=np.float64),
            probs=np.array(j.probs, dtype=np.float64),
            arrival=float(j.arrival),
            job_id=int(j.job_id),
            outcome_stage=int(j.outcome_stage),
        )
        for j in jobs
    ]
