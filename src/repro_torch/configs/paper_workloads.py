"""The paper's own experiment configurations (Section IV / VI).

Not a neural architecture: the paper's workloads are job-size
distributions.  These configs drive benchmarks/run.py and the cluster
examples."""

from __future__ import annotations

import dataclasses

__all__ = ["NumericalStudy", "TraceStudy", "NUMERICAL", "TRACE"]


@dataclasses.dataclass(frozen=True)
class NumericalStudy:
    """Section IV setup: workload sets 1-5 (Table III)."""

    workload_sets: tuple[int, ...] = (1, 2, 3, 4, 5)
    n_jobs_sweep: tuple[int, ...] = (3, 4, 5, 6, 7, 8)  # OPTIMAL tractable
    n_jobs_extended: tuple[int, ...] = (3, 5, 7, 9, 11, 13, 15, 17)
    num_stages: int = 2
    stages_sweep: tuple[int, ...] = (2, 3, 4, 5, 6, 7, 8)  # Table XIV
    trials: int = 50_000  # paper: "at least 50000"
    trials_fast: int = 2_000  # CI-friendly subset
    algorithms: tuple[str, ...] = ("rank", "serpt", "sr", "random")


@dataclasses.dataclass(frozen=True)
class TraceStudy:
    """Section VI setup: Philly-statistics trace + synthetic variants."""

    n_jobs: int = 109_967
    duration_days: float = 75.0
    server_counts: tuple[int, ...] = (5, 10, 20, 50, 80, 100, 200, 300)
    policies: tuple[str, ...] = ("fifo", "serpt", "rank", "sr")
    synthetic_success_probs: tuple[float | None, ...] = (None, 0.5, 0.25)
    n_jobs_fast: int = 20_000  # CI-friendly subset


NUMERICAL = NumericalStudy()
TRACE = TraceStudy()
