"""Exact and Monte-Carlo evaluation of expected sojourn time of successful jobs.

The counterpart of ``repro/core/evaluator.py``.  The paper (Section
IV-A1) evaluates a schedule *exactly* by enumerating all combinations of
per-job outcomes (which checkpoint each job stops at), weighting each
combination by its probability:

* :func:`expected_sojourn_static` — a batch of static non-preemptive
  orders (RANK / RANDOM / OPTIMAL; Theorem III.1) through the fused
  :func:`repro_torch.kernels.sojourn_eval.sojourn_eval` op.
* :func:`expected_sojourn_dynamic` — stage-level policies (SR / SERPT)
  on ``n_servers`` servers through
  :func:`repro_torch.kernels.sojourn_eval.sojourn_eval_dynamic`.
* :func:`optimal_order` — exhaustive search over permutations (N <= 9).
* Beyond ``MAX_EXACT_COMBOS`` both ops switch to *streaming* Monte Carlo
  via ``samples=(seed, n_samples)``, from a counter-based Threefry stream
  shared by every policy under one seed (common random numbers).

Everything runs in float64, on the CUDA card unless ``device="cpu"`` is
passed.  Workloads, random orders and the Monte-Carlo seed come from a
caller-given ``np.random.Generator``, consumed in exactly the reference's
order, so one seed gives the reference's numbers.  The explicit
``outcomes=``/``weights=`` tier (the ``sojourn_outcomes`` kernel) is not
ported yet and raises ``NotImplementedError``.

Conventions: a combination with zero successful jobs contributes 0 (the
paper's Eqs. (7)-(9) sum from l >= 1 successes).
"""

from __future__ import annotations

import itertools

import numpy as np

from repro_torch.core import policies
from repro_torch.core.jobs import Workload
from repro_torch.kernels.sojourn_eval import rng as kernel_rng
from repro_torch.kernels.sojourn_eval import sojourn_eval, sojourn_eval_dynamic
from repro_torch.kernels.sojourn_eval.ops import OUTCOMES_NOT_PORTED
from repro_torch.kernels.sojourn_eval.ref import mixed_radix_strides

__all__ = [
    "MAX_EXACT_COMBOS",
    "MAX_MATERIALIZED_COMBOS",
    "exact_combination_count",
    "expected_sojourn_static",
    "expected_sojourn_dynamic",
    "optimal_order",
    "evaluate",
    "evaluate_many",
]

#: Above this many outcome combinations, exact evaluation (which streams
#: combinations through the fused kernels without materializing them)
#: gives way to Monte Carlo.
MAX_EXACT_COMBOS = 1 << 26

#: Above this many combinations, a (K, N) outcome table is too large to
#: materialize (the explicit-table tier).
MAX_MATERIALIZED_COMBOS = 1 << 21


def _enum_meta(jobs: Workload) -> tuple[int, np.ndarray, np.ndarray]:
    """Cached (K, strides, num_stages) mixed-radix enumeration metadata."""

    def compute():
        _, _, num_stages = policies.padded_arrays(jobs)
        k_total = int(np.prod(num_stages, dtype=np.int64))
        return k_total, mixed_radix_strides(num_stages), num_stages

    return policies.workload_cached("enum_meta", jobs, compute)


def exact_combination_count(jobs: Workload) -> int:
    return _enum_meta(jobs)[0]


def _check_exact(jobs: Workload) -> None:
    k_total = exact_combination_count(jobs)
    if k_total > MAX_EXACT_COMBOS:
        raise ValueError(
            f"{k_total} combinations exceed MAX_EXACT_COMBOS; use "
            "samples=(seed, n_samples)"
        )


def expected_sojourn_static(
    jobs: Workload,
    orders: np.ndarray,
    outcomes: np.ndarray | None = None,
    weights: np.ndarray | None = None,
    also_all_jobs: bool = False,
    samples: tuple[int, int] | None = None,
    device=None,
):
    """Expected sojourn of successful jobs for static order(s), fused.

    ``orders`` may be (N,) for a single order or (P, N) for a batch.
    With ``samples=None`` the evaluation is exact: all ``prod(M_i)``
    combinations are enumerated inside the kernel (up to
    ``MAX_EXACT_COMBOS``).  ``samples=(seed, n_samples)`` runs streaming
    Monte Carlo.  Returns a float for one order, a (P,) array for a
    batch, and ``(e_succ, e_all)`` with ``also_all_jobs``.
    """
    if outcomes is not None or weights is not None:
        raise NotImplementedError(OUTCOMES_NOT_PORTED)
    orders = np.asarray(orders, dtype=np.int32)
    single = orders.ndim == 1
    if single:
        orders = orders[None]
    sizes, probs, num_stages = policies.padded_arrays(jobs)
    if samples is None:
        _check_exact(jobs)
    e_succ, e_all = sojourn_eval(
        sizes, probs, num_stages, orders, samples=samples, device=device
    )
    if also_all_jobs:
        return (e_succ[0], e_all[0]) if single else (e_succ, e_all)
    return float(e_succ[0]) if single else e_succ


def expected_sojourn_dynamic(
    jobs: Workload,
    policy: str,
    outcomes: np.ndarray | None = None,
    weights: np.ndarray | None = None,
    samples: tuple[int, int] | None = None,
    n_servers: int = 1,
    device=None,
) -> float:
    """Expected sojourn of successful jobs for a stage-level policy.

    With ``samples=None`` the evaluation is exact: all ``prod(M_i)``
    combinations are decoded and simulated inside the fused dynamic
    kernel (up to ``MAX_EXACT_COMBOS``).  ``samples=(seed, n_samples)``
    runs streaming Monte Carlo from the stream shared with the static op.
    ``n_servers=W`` evaluates the paper's multi-server setting.
    """
    if outcomes is not None or weights is not None:
        raise NotImplementedError(OUTCOMES_NOT_PORTED)
    _, probs, num_stages = policies.padded_arrays(jobs)
    idx_table = policies.index_table(jobs, policy)
    stage_durs = policies.stage_durations(jobs)
    if samples is None:
        _check_exact(jobs)
    e_succ, _ = sojourn_eval_dynamic(
        probs, stage_durs, num_stages, idx_table,
        samples=samples, n_servers=n_servers, device=device,
    )
    return float(e_succ[0])


def optimal_order(
    jobs: Workload, max_n: int = 9, device=None
) -> tuple[np.ndarray, float]:
    """Exhaustive search over all N! non-preemptive orders (Thm III.1)."""
    n = len(jobs)
    if n > max_n:
        raise ValueError(f"exhaustive search with N={n} > {max_n} is too expensive")
    orders = np.array(list(itertools.permutations(range(n))), dtype=np.int32)
    vals = expected_sojourn_static(jobs, orders, device=device)
    best = int(np.argmin(vals))
    return orders[best], float(vals[best])


def evaluate(
    jobs: Workload,
    policy: str,
    rng: np.random.Generator | None = None,
    outcomes: np.ndarray | None = None,
    weights: np.ndarray | None = None,
    samples: tuple[int, int] | None = None,
    device=None,
) -> float:
    """Expected sojourn time of successful jobs under ``policy``.

    Policies: 'rank' | 'serpt' | 'sr' | 'random' | 'optimal'.
    RANK and RANDOM are static orders (Theorem III.1); SERPT and SR are
    stage-level index policies as in the paper's Section III-A examples.
    """
    if policy == "rank":
        return expected_sojourn_static(
            jobs, policies.rank_order(jobs), outcomes, weights, samples=samples,
            device=device,
        )
    if policy == "random":
        if rng is None:
            raise ValueError("random policy needs an rng")
        return expected_sojourn_static(
            jobs, policies.random_order(jobs, rng), outcomes, weights,
            samples=samples, device=device,
        )
    if policy == "optimal":
        _, val = optimal_order(jobs, device=device)
        return val
    if policy in ("serpt", "sr"):
        return expected_sojourn_dynamic(
            jobs, policy, outcomes, weights, samples=samples, device=device
        )
    raise ValueError(f"unknown policy {policy!r}")


def evaluate_many(
    jobs: Workload,
    algs: tuple[str, ...],
    rng: np.random.Generator,
    mc_samples: int = 4096,
    device=None,
) -> dict[str, float]:
    """Evaluate several policies on one job group, sharing random numbers.

    Two regimes by combination count K:
      * K <= MAX_EXACT_COMBOS: everything is exact.
      * otherwise: streaming Monte Carlo with one seed drawn from ``rng``
        and shared by every policy (common random numbers).
    """
    k_total = exact_combination_count(jobs)
    if k_total <= MAX_EXACT_COMBOS:
        return {alg: evaluate(jobs, alg, rng=rng, device=device) for alg in algs}
    seed = int(rng.integers(0, kernel_rng.MAX_SEED))
    return {
        alg: evaluate(jobs, alg, rng=rng, samples=(seed, mc_samples), device=device)
        for alg in algs
    }
