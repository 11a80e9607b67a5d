"""Philly-like trace synthesis (paper Section VI-A).

The paper uses the Microsoft Philly trace (Jeon et al., ATC'19): 117,325
jobs over 75 days; 109,967 usable after filtering.  That CSV is not
redistributable with this repository, so we synthesize a trace that
matches the published statistics the paper reports:

* attempt-count distribution (paper Table XV),
* job category split: 75% passed / 15% failed / 10% killed,
* 75-day arrival window (Poisson arrivals),
* heavy-tailed attempt durations (log-normal).

Mapping to the paper's job model: each *attempt* is a stage; a passed job
succeeds at its last observed stage; failed/killed jobs terminate early at
their last observed stage, and extra hypothetical stages (never executed)
are appended so the scheduler's size distribution extends beyond the
realized outcome — exactly the paper's construction.  Per-stage success
probabilities are sampled (uniform hazards), with the option to pin the
final success probability (synthetic data sets I and II use 0.5 / 0.25).

``load_trace_csv`` accepts a real Philly-style CSV when one is available,
so results can be regenerated on the true trace.

The port's counterpart of ``repro/core/trace.py``: the same ``rng`` calls
in the same order, so one seed gives the reference's jobs field for field.
"""

from __future__ import annotations

import csv

import numpy as np

from repro_torch.core.jobs import JobSpec

__all__ = ["synthesize_trace", "load_trace_csv", "ATTEMPT_COUNTS", "CATEGORY_PROBS"]

#: Paper Table XV (number of attempts -> job count).
ATTEMPT_COUNTS = {1: 95188, 2: 5465, 3: 1674, 4: 954, 5: 6574, 6: 67, 7: 1}

#: Paper Section VI-A: passed / failed / killed.
CATEGORY_PROBS = {"passed": 82445 / 109967, "failed": 16927 / 109967, "killed": 10595 / 109967}

#: Log-normal attempt-duration parameters (seconds).  Chosen so that the
#: offered load at the paper's server counts (5..300) spans the same
#: overloaded->stable regime as Tables XVI-XVIII (median ~25 min, heavy
#: tail; utilization ~0.9 at 300 servers, >>1 at 5-100).
DURATION_MU = np.log(1500.0)
DURATION_SIGMA = 1.9

#: Category correlates with attempt count (resubmissions indicate failure):
#: P(passed | attempts=a) = _PASS_BASE * _PASS_DECAY**(a-1), calibrated so
#: the marginal split stays ~75/15/10 under the Table XV attempt counts.
_PASS_BASE = 0.85
_PASS_DECAY = 0.3

SECONDS_PER_DAY = 86400.0


def _stage_probs(
    rng: np.random.Generator, m: int, success_prob: float | None
) -> np.ndarray:
    """Termination distribution over m stages via uniform per-checkpoint hazards."""
    if m == 1:
        return np.array([1.0])
    hazards = rng.uniform(0.0, 1.0, size=m - 1)
    probs = np.empty(m)
    surv = 1.0
    for j in range(m - 1):
        probs[j] = surv * hazards[j]
        surv *= 1.0 - hazards[j]
    probs[m - 1] = surv
    if success_prob is not None:
        # Pin p_M (synthetic sets I/II) and rescale the early mass.
        probs[: m - 1] *= (1.0 - success_prob) / max(probs[: m - 1].sum(), 1e-12)
        probs[m - 1] = success_prob
    return probs


def synthesize_trace(
    rng: np.random.Generator,
    n_jobs: int = 109_967,
    duration_days: float = 75.0,
    success_prob: float | None = None,
    extra_stages_max: int = 3,
) -> list[JobSpec]:
    """Generate a Philly-statistics-matched workload with realized outcomes."""
    attempts_vals = np.array(sorted(ATTEMPT_COUNTS))
    attempts_p = np.array([ATTEMPT_COUNTS[k] for k in attempts_vals], dtype=np.float64)
    attempts_p /= attempts_p.sum()

    arrivals = np.sort(rng.uniform(0.0, duration_days * SECONDS_PER_DAY, size=n_jobs))
    observed = rng.choice(attempts_vals, size=n_jobs, p=attempts_p)
    # category | attempts: repeated attempts indicate failure
    p_pass = _PASS_BASE * _PASS_DECAY ** (observed - 1)
    u = rng.uniform(size=n_jobs)
    fail_frac = CATEGORY_PROBS["failed"] / (
        CATEGORY_PROBS["failed"] + CATEGORY_PROBS["killed"]
    )
    category = np.where(
        u < p_pass, "passed",
        np.where(rng.uniform(size=n_jobs) < fail_frac, "failed", "killed"),
    )

    jobs = []
    for i in range(n_jobs):
        k = int(observed[i])
        if category[i] == "passed":
            m = k  # succeeds at its final observed stage
            outcome = m - 1
        else:
            # failed/killed: terminated at stage k; append hypothetical stages
            extra = int(rng.integers(1, extra_stages_max + 1))
            m = k + extra
            outcome = k - 1
        durs = rng.lognormal(DURATION_MU, DURATION_SIGMA, size=m)
        sizes = np.cumsum(np.maximum(durs, 1.0))
        probs = _stage_probs(rng, m, success_prob)
        jobs.append(
            JobSpec(
                sizes=sizes,
                probs=probs,
                arrival=float(arrivals[i]),
                job_id=i,
                outcome_stage=outcome,
            )
        )
    return jobs


def load_trace_csv(
    path: str,
    rng: np.random.Generator,
    success_prob: float | None = None,
    extra_stages_max: int = 3,
) -> list[JobSpec]:
    """Load a real trace CSV: columns job_id,arrival,category,attempt_durations.

    ``attempt_durations`` is a ';'-separated list of per-attempt seconds.
    The same stage/probability construction as :func:`synthesize_trace` is
    applied (paper Section VI-A).
    """
    jobs = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            durs = np.array([float(x) for x in row["attempt_durations"].split(";")])
            k = len(durs)
            if k == 0:
                continue
            if row["category"] == "passed":
                m, outcome = k, k - 1
            else:
                extra = int(rng.integers(1, extra_stages_max + 1))
                extra_durs = rng.lognormal(DURATION_MU, DURATION_SIGMA, size=extra)
                durs = np.concatenate([durs, extra_durs])
                m, outcome = k + extra, k - 1
            sizes = np.cumsum(np.maximum(durs, 1.0))
            jobs.append(
                JobSpec(
                    sizes=sizes,
                    probs=_stage_probs(rng, m, success_prob),
                    arrival=float(row["arrival"]),
                    job_id=int(row["job_id"]),
                    outcome_stage=outcome,
                )
            )
    return jobs
