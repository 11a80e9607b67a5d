"""Discrete-event simulator for the online multi-server setting (paper §V-VI).

Implements the paper's online approach: W homogeneous servers; when a new
job arrives it is served immediately if a server is free, otherwise queued.
When a server completes a *stage* of a job, it serves the minimum-index job
among {ready queue} ∪ {the job it just served} — i.e. stage-boundary
preemption driven by a policy index table (rank / SERPT / SR / FIFO).

This is a thin frontend over the unified engine in
:mod:`repro_torch.core.des.engine` (which also drives the cluster manager):
the hooks here are pure table lookups — policy index, padded stage
duration plus a fixed overhead, and a pre-realized outcome stage.
Events at the same instant are drained as one batch before dispatch, so
simultaneous arrivals (the paper's static setting: all jobs present at
t=0) contend by policy index, ties by job position — matching the exact
lockstep evaluators in :mod:`repro_torch.kernels.sojourn_eval`.

The index is *conditional on progress*: a partially-served job competes
with its up-to-date conditional index (see
:func:`repro_torch.core.policies.rank_index_table`).

The port's counterpart of ``repro/core/simulator.py``, equal to it bit
for bit on the same inputs.  :func:`simulate` takes no ``device``: the
reference's online path does no device work, and neither does this one.
It is host code by design, not a fallback.  Where an index is ``+inf``
the DES serves the job last and the fused kernels never seat it (see
:mod:`repro_torch.core.des.engine`, ROADMAP fault R2).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import policies
from repro_torch.core.des import ARRIVAL, Engine, ReadyQueue, SchedulerHooks  # noqa: F401
from repro_torch.core.jobs import Workload

__all__ = ["SimResult", "ReadyQueue", "simulate"]


@dataclasses.dataclass
class SimResult:
    mean_sojourn_successful: float
    mean_sojourn_all: float
    n_success: int
    n_jobs: int
    makespan: float
    policy: str
    n_servers: int

    def as_row(self) -> dict:
        return dataclasses.asdict(self)


def _realize_outcomes(jobs: Workload, rng: np.random.Generator | None) -> np.ndarray:
    out = np.empty(len(jobs), dtype=np.int64)
    for i, j in enumerate(jobs):
        if j.outcome_stage >= 0:
            out[i] = j.outcome_stage
        else:
            if rng is None:
                raise ValueError("jobs without fixed outcomes need an rng")
            out[i] = rng.choice(j.num_stages, p=j.probs)
    return out


class _TableHooks(SchedulerHooks):
    """Trace-study hooks: everything is a precomputed table lookup."""

    def __init__(self, idx_table, stage_durs, outcomes, num_stages, stage_overhead):
        self.idx_table = idx_table
        self.stage_durs = stage_durs
        self.outcomes = outcomes
        self.num_stages = num_stages
        self.stage_overhead = stage_overhead

    def index(self, job: int, stage: int) -> float:
        return float(self.idx_table[job, stage])

    def stage_duration(self, job: int, stage: int, now: float) -> float:
        return float(self.stage_durs[job, stage]) + self.stage_overhead

    def outcome(self, job: int) -> int:
        return int(self.outcomes[job])

    def is_success(self, job: int) -> bool:
        return bool(self.outcomes[job] == self.num_stages[job] - 1)


def simulate(
    jobs: Workload,
    n_servers: int,
    policy: str = "rank",
    idx_table: np.ndarray | None = None,
    rng: np.random.Generator | None = None,
    stage_overhead: float = 0.0,
    recorder=None,
    metrics=None,
) -> SimResult:
    """Run the online scheduler over a trace.

    Args:
      jobs: workload; each job's ``arrival`` is honored and its realized
        ``outcome_stage`` is used if set (trace-driven), else sampled.
      n_servers: W homogeneous servers.
      policy: 'rank' | 'serpt' | 'sr' | 'fifo' (index tables per paper).
      idx_table: optional precomputed (N, M) index table (overrides policy).
      stage_overhead: optional fixed checkpoint overhead added per stage
        (0 reproduces the paper; >0 models checkpoint save cost).
      recorder: optional :class:`repro_torch.obs.TraceRecorder` (or any
        :class:`~repro_torch.core.des.events.EngineObserver`) receiving the
        batched trace records; attaching one never changes results.
      metrics: optional :class:`repro_torch.obs.MetricsRegistry` populated
        with the standard run metrics (sojourn percentiles by outcome,
        busy fraction, wasted work).
    """
    n = len(jobs)
    # Workload-keyed cache: padded arrays, stage durations and the policy
    # index table are computed once per workload, not once per trial.
    _, _, num_stages = policies.padded_arrays(jobs)
    stage_durs = policies.stage_durations(jobs)
    if idx_table is None:
        idx_table = policies.index_table(jobs, policy)
    outcomes = _realize_outcomes(jobs, rng)
    arrivals = np.array([j.arrival for j in jobs])

    eng = Engine(
        n,
        n_servers,
        _TableHooks(idx_table, stage_durs, outcomes, num_stages, stage_overhead),
        observer=recorder,
    )
    for i in range(n):
        eng.schedule(float(arrivals[i]), ARRIVAL, i)
    eng.run()

    success = outcomes == (num_stages - 1)
    sojourn = eng.completion - arrivals
    assert not np.any(np.isnan(sojourn)), "all jobs must finish"
    if metrics is not None:
        from repro_torch.obs.metrics import record_run_metrics

        record_run_metrics(metrics, eng, arrivals, success)
    return SimResult(
        mean_sojourn_successful=float(sojourn[success].mean()) if success.any() else 0.0,
        mean_sojourn_all=float(sojourn.mean()),
        n_success=int(success.sum()),
        n_jobs=n,
        makespan=float(eng.makespan),
        policy=policy,
        n_servers=n_servers,
    )
