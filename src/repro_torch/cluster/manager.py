"""Cluster manager: the paper's online RANK policy driving real training jobs.

This is the integration layer that makes the paper's contribution a
first-class framework feature:

* A :class:`TrainingJob` is a DNN training program with checkpoint-based
  early termination: a *stage* is ``steps_per_stage`` optimizer steps; at
  each stage boundary a metric gate (e.g. validation-loss plateau) decides
  whether the job continues — exactly the paper's multi-stage job model,
  with the size distribution estimated from historical jobs.
* Scheduling is the unified discrete-event engine
  (:mod:`repro_torch.core.des.engine`, shared with ``core/simulator.py``):
  jobs are held in a priority queue keyed by their *conditional rank*
  (Eq. 23 updated on survived stages); same-instant events are drained
  as one batch before dispatch, so simultaneous arrivals contend by
  policy index, and a job finishing a stage re-competes with the whole
  queue at its new index (paper §V).
* Fault tolerance: per-node exponential failures abort the affected
  job's in-flight stage; the job resumes **the same stage** from its last
  checkpoint (plus restart overhead) — failures never advance or
  terminate a job (distinct from the paper's early termination).
* Straggler mitigation: a stage whose runtime exceeds
  ``deadline_factor × EWMA`` is re-dispatched (duplicate-and-race, the
  winner counts).
* Elastic scaling: ``resize(n_servers, at_time)`` events add/drain
  servers; grow is immediate, shrink retires idle servers immediately
  and busy ones at stage boundaries (including failure aborts), so
  ``len(running) + free <= target_servers`` holds at every event.

Jobs can be *simulated* (durations from the JobSpec — used for the
paper-scale studies) or *real* (a runner callback executes real training
stages on this host).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.cluster.faults import FaultConfig, FaultInjector
from repro_torch.core import policies
from repro_torch.core.des import ARRIVAL, FAILURE, RESIZE, Engine, SchedulerHooks
from repro_torch.core.jobs import JobSpec

__all__ = ["TrainingJob", "ClusterManager", "ClusterResult"]


@dataclasses.dataclass
class TrainingJob:
    """A multi-stage job: spec for the scheduler + optional real runner."""

    spec: JobSpec
    steps_per_stage: int = 50
    # runner(job, stage_idx) -> (wall_seconds, terminated_early: bool)
    runner: Callable | None = None
    name: str = ""

    # runtime state (managed by ClusterManager)
    stage: int = 0
    completed: float = float("nan")
    success: bool = False
    restarts: int = 0
    straggler_redispatches: int = 0

    def realized_stop_stage(self, rng: np.random.Generator) -> int:
        if self.spec.outcome_stage >= 0:
            return self.spec.outcome_stage
        return int(rng.choice(self.spec.num_stages, p=self.spec.probs))


@dataclasses.dataclass
class ClusterResult:
    mean_sojourn_successful: float
    mean_sojourn_all: float
    n_success: int
    n_jobs: int
    makespan: float
    restarts: int
    straggler_redispatches: int
    policy: str


class _ClusterHooks(SchedulerHooks):
    """Fault / straggler / real-runner behavior on top of the engine."""

    def __init__(self, mgr: "ClusterManager"):
        self.mgr = mgr
        self.ewma: float | None = None

    def index(self, job: int, stage: int) -> float:
        return float(self.mgr.idx_table[job, stage])

    def stage_duration(self, job: int, stage: int, now: float) -> float:
        mgr = self.mgr
        dur = mgr._stage_nominal(job, stage)
        if mgr.faults is not None:
            dur, straggled = mgr.faults.stage_runtime(dur)
            if self.ewma is not None and dur > mgr.faults.cfg.deadline_factor * self.ewma:
                # duplicate-and-race: winner is the nominal re-dispatch
                mgr.jobs[job].straggler_redispatches += 1
                dur = min(dur, mgr._stage_nominal(job, stage))
        self.ewma = dur if self.ewma is None else 0.9 * self.ewma + 0.1 * dur
        return dur

    def outcome(self, job: int) -> int:
        # read at stage-completion time: a real runner's metric gate may
        # have overridden the realized outcome while the stage ran
        return int(self.mgr._outcomes[job])

    def is_success(self, job: int) -> bool:
        mgr = self.mgr
        return bool(mgr._outcomes[job] == mgr.jobs[job].spec.num_stages - 1)

    def on_complete(self, job: int, now: float) -> None:
        tj = self.mgr.jobs[job]
        tj.completed = now
        tj.success = self.mgr._outcomes[job] == tj.spec.num_stages - 1

    def on_failure(self, engine: Engine, now: float) -> None:
        mgr = self.mgr
        if engine.pool.running:
            # pick a random running job (gangs are node-disjoint)
            job = list(engine.pool.running.keys())[mgr.rng.integers(engine.pool.busy)]
            mgr.jobs[job].restarts += 1
            # abort in-flight stage: the server frees (or drains, under a
            # shrink) during the checkpoint-restore window; the job
            # re-arrives at the same stage after the restart overhead
            engine.abort(job)
            engine.schedule(now + mgr.faults.cfg.restart_overhead, ARRIVAL, job)
        if engine.n_done < engine.n_jobs:  # re-arm only while work remains
            t_fail = mgr.faults.next_failure_time(now, mgr._total_nodes())
            engine.schedule(t_fail, FAILURE)


class ClusterManager:
    def __init__(
        self,
        jobs: list[TrainingJob],
        n_servers: int,
        policy: str = "rank",
        fault_cfg: FaultConfig | None = None,
        nodes_per_server: int = 1,
        rng: np.random.Generator | None = None,
        resize_events: list[tuple[float, int]] | None = None,
    ):
        self.jobs = jobs
        self.n_servers = n_servers
        self.policy = policy
        self.rng = rng or np.random.default_rng(0)
        self.faults = FaultInjector(fault_cfg, self.rng) if fault_cfg else None
        self.nodes_per_server = nodes_per_server
        self.resize_events = sorted(resize_events or [])
        specs = [j.spec for j in jobs]
        # Both tables come from the workload-keyed cache, so repeated
        # manager runs over the same workload (policy sweeps, fault-config
        # sweeps) reuse one computation.  _stage_durs is the padded (N, M)
        # increment matrix; stages >= num_stages are never dispatched.
        self.idx_table = policies.index_table(specs, policy)
        self._stage_durs = policies.stage_durations(specs)
        self._outcomes = np.array(
            [j.realized_stop_stage(self.rng) for j in jobs], dtype=np.int64
        )

    def _stage_nominal(self, j: int, stage: int) -> float:
        job = self.jobs[j]
        if job.runner is not None:
            wall, terminated = job.runner(job, stage)
            # a real runner also overrides the realized outcome
            if terminated:
                self._outcomes[j] = min(stage, job.spec.num_stages - 1)
            return float(wall)
        return float(self._stage_durs[j][stage])

    def run(self, observer=None, recorder=None, metrics=None) -> ClusterResult:
        """Schedule the jobs to completion; returns a :class:`ClusterResult`.

        Args:
          observer: deprecated bare callable ``observer(engine, now)``
            (per-event, unbatched); prefer ``recorder``.
          recorder: optional :class:`repro_torch.obs.TraceRecorder` (or any
            :class:`~repro_torch.core.des.events.EngineObserver`) receiving
            batched trace records; never changes scheduling results.
          metrics: optional :class:`repro_torch.obs.MetricsRegistry` populated
            with the standard run metrics plus restart / straggler
            counters.
        """
        jobs = self.jobs
        n = len(jobs)
        eng = Engine(
            n, self.n_servers, _ClusterHooks(self), observer=[observer, recorder]
        )
        for i, j in enumerate(jobs):
            eng.schedule(j.spec.arrival, ARRIVAL, i)
        for t, target in self.resize_events:
            eng.schedule(t, RESIZE, target)
        if self.faults is not None:
            eng.schedule(self.faults.next_failure_time(0.0, self._total_nodes()), FAILURE)
        eng.run()

        for i, j in enumerate(jobs):  # expose per-job progress post-run
            j.stage = int(eng.stage[i])

        arrivals = np.array([j.spec.arrival for j in jobs])
        success = np.array(
            [self._outcomes[i] == jobs[i].spec.num_stages - 1 for i in range(n)]
        )
        sojourn = eng.completion - arrivals
        if metrics is not None:
            from repro_torch.obs.metrics import record_run_metrics

            record_run_metrics(metrics, eng, arrivals, success)
            metrics.counter("jobs.restarts").inc(sum(j.restarts for j in jobs))
            metrics.counter("jobs.straggler_redispatches").inc(
                sum(j.straggler_redispatches for j in jobs)
            )
        return ClusterResult(
            mean_sojourn_successful=float(sojourn[success].mean()) if success.any() else 0.0,
            mean_sojourn_all=float(np.nanmean(sojourn)),
            n_success=int(success.sum()),
            n_jobs=n,
            makespan=float(eng.makespan),
            restarts=sum(j.restarts for j in jobs),
            straggler_redispatches=sum(j.straggler_redispatches for j in jobs),
            policy=self.policy,
        )

    def _total_nodes(self) -> int:
        return self.n_servers * self.nodes_per_server
