"""Failure / straggler models for the cluster manager and the DES.

Per-node failures follow an exponential MTBF; at 1000+ nodes the fleet
failure rate is roughly (nodes / MTBF) per hour — e.g. 4k nodes at 30-day
MTBF ≈ 5.5 failures/hour, which is why checkpoint/restart and fast gang
rescheduling are first-class here.

Stragglers: a multiplicative slowdown drawn with probability
``straggler_prob`` per (job, stage) dispatch — the DES re-dispatches a
stage whose runtime exceeds ``deadline_factor`` × EWMA."""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FaultConfig", "FaultInjector"]


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    mtbf_hours: float = 24.0 * 30  # per node
    straggler_prob: float = 0.02
    straggler_slowdown: float = 4.0
    deadline_factor: float = 3.0
    restart_overhead: float = 60.0  # seconds to gang-restart from checkpoint


class FaultInjector:
    def __init__(self, cfg: FaultConfig, rng: np.random.Generator):
        self.cfg = cfg
        self.rng = rng

    def next_failure_time(self, now: float, n_nodes: int) -> float:
        """Time of the next node failure across a gang of n_nodes."""
        rate = n_nodes / (self.cfg.mtbf_hours * 3600.0)
        return now + float(self.rng.exponential(1.0 / max(rate, 1e-12)))

    def stage_runtime(self, nominal: float) -> tuple[float, bool]:
        """Possibly-straggled runtime for one dispatched stage."""
        if self.rng.uniform() < self.cfg.straggler_prob:
            return nominal * self.cfg.straggler_slowdown, True
        return nominal, False
