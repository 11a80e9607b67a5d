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
* The materialized tier, up to ``MAX_MATERIALIZED_COMBOS``: explicit
  ``outcomes=``/``weights=`` tables from :func:`enumerate_outcomes` or
  :func:`sample_outcomes`.  Static orders run them through the
  ``sojourn_outcomes`` kernel; stage-level policies through
  :func:`_dynamic_batch`, the reference's single-server lockstep
  simulation in plain PyTorch.  :func:`_static_batch` is the seed path
  kept as an oracle.

Everything runs in float64, on the CUDA card unless ``device="cpu"`` is
passed.  Workloads, random orders, sampled outcomes and the Monte-Carlo
seed come from a caller-given ``np.random.Generator``, consumed in
exactly the reference's order, so one seed gives the reference's numbers.

Conventions: a combination with zero successful jobs contributes 0 (the
paper's Eqs. (7)-(9) sum from l >= 1 successes).

With :mod:`repro_torch.obs.profiling` on, the host work before each op
call is a span ``entry.plan.<name>``: ``group`` (:func:`evaluate_many`'s
combination count and Monte-Carlo seed), ``rank``, ``random`` and
``optimal`` (the order, or the N! orders), ``static`` (the static op's
padded arrays and checks) and a stage-level policy's name (its index
table, padded arrays and stage durations).  No plan span holds an op
call or another plan span.

One departure from the reference, on purpose: the combination count K
is a Python integer (``math.prod``), where the reference takes
``np.prod`` in int64, which wraps at 63 or more two-stage jobs and then
raises ``OverflowError``.  Here such groups go to the streamed
Monte-Carlo tier, as any K above ``MAX_EXACT_COMBOS`` does.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from repro_torch.core import policies
from repro_torch.core.jobs import Workload
from repro_torch.device import resolve_device
from repro_torch.kernels.sojourn_eval import rng as kernel_rng
from repro_torch.kernels.sojourn_eval import sojourn_eval, sojourn_eval_dynamic
from repro_torch.kernels.sojourn_eval.ref import mixed_radix_strides
from repro_torch.obs import profiling

__all__ = [
    "MAX_EXACT_COMBOS",
    "MAX_MATERIALIZED_COMBOS",
    "exact_combination_count",
    "enumerate_outcomes",
    "sample_outcomes",
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
        # a Python int: np.prod in int64 wraps at 63 two-stage jobs
        k_total = math.prod(int(m) for m in num_stages)
        return k_total, mixed_radix_strides(num_stages), num_stages

    return policies.workload_cached("enum_meta", jobs, compute)


def exact_combination_count(jobs: Workload) -> int:
    return _enum_meta(jobs)[0]


def enumerate_outcomes(jobs: Workload) -> tuple[np.ndarray, np.ndarray]:
    """All outcome combinations, materialized.

    Returns ``outcomes`` (K, N) int32, the stage at which each job stops
    (M_i - 1 == success), and ``weights`` (K,) float64, the probability of
    each combination.  Only valid up to ``MAX_MATERIALIZED_COMBOS``; the
    fused evaluator handles larger exact enumerations without a table.
    """
    _, probs, _ = policies.padded_arrays(jobs)
    k_total, strides, num_stages = _enum_meta(jobs)
    if k_total > MAX_MATERIALIZED_COMBOS:
        raise ValueError(
            f"{k_total} combinations exceed MAX_MATERIALIZED_COMBOS; use "
            "sample_outcomes, or expected_sojourn_static(outcomes=None) "
            "which enumerates inside the fused kernel"
        )
    k = np.arange(k_total, dtype=np.int64)
    outcomes = ((k[:, None] // strides[None, :]) % num_stages[None, :]).astype(np.int32)
    weights = np.prod(probs[np.arange(len(jobs))[None, :], outcomes], axis=1, dtype=np.float64)
    return outcomes, weights


def sample_outcomes(
    jobs: Workload, n_samples: int, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    """Monte-Carlo outcomes by inverse-CDF sampling of one (S, N) block of
    ``rng.random``; weights are uniform 1/S."""
    _, probs, num_stages = policies.padded_arrays(jobs)
    cdf = np.cumsum(probs, axis=1)  # (N, M); padded stages add 0 mass
    u = rng.random((n_samples, len(jobs)))
    outcomes = np.sum(u[:, :, None] >= cdf[None, :, :], axis=2)
    outcomes = np.minimum(outcomes, num_stages[None, :] - 1).astype(np.int32)
    weights = np.full((n_samples,), 1.0 / n_samples)
    return outcomes, weights


def _realized_arrays(jobs: Workload, outcomes: np.ndarray):
    """Per-combination realized durations (K, N) and success masks (K, N)."""
    sizes, _, num_stages = policies.padded_arrays(jobs)
    durations = sizes[np.arange(len(jobs)), outcomes]
    success = outcomes == (num_stages[None, :] - 1)
    return durations, success


def _static_batch(durations, success, weights, orders, also_all_jobs=False):
    """Seed path: E[sojourn of successful jobs] per order, dense.

    Kept as the oracle of the fused op.  ``durations`` (K, N) realized
    total service, ``success`` (K, N) bool, ``weights`` (K,), ``orders``
    (P, N): torch tensors on one device.  Returns (P,) float64, or
    ``(e_succ, e_all)`` with ``also_all_jobs``.
    """
    e_succ, e_all = [], []
    for order in orders.to(torch.int64):
        t = torch.cumsum(durations[:, order], dim=1)  # completion times
        s = success[:, order]
        cnt = s.sum(dim=1)
        tot = (t * s).sum(dim=1)
        mean_succ = torch.where(cnt > 0, tot / cnt.clamp(min=1), 0.0)
        e_succ.append(weights @ mean_succ)
        e_all.append(weights @ t.mean(dim=1))
    if also_all_jobs:
        return torch.stack(e_succ), torch.stack(e_all)
    return torch.stack(e_succ)


def _dynamic_batch(idx_table, stage_durs, outcomes, success, weights, total_stages: int):
    """Simulate a stage-level index policy on one server for every row of
    an outcome table; the materialized tier of :func:`expected_sojourn_dynamic`.

    The reference's lockstep loop with the combinations as a batch axis:
    ``total_stages`` steps, each serving the alive job of least index
    (``argmin``: ties to the lowest position) for one stage.  Indices
    clamp as JAX's gathers do, so a row whose alive jobs all have index
    ``+inf`` behaves as in the reference (ROADMAP fault R2).

    idx_table, stage_durs (N, M) float64; outcomes (K, N) int; success
    (K, N) bool; weights (K,) float64: torch tensors on one device.
    """
    k, n = outcomes.shape
    m = idx_table.shape[1]
    dev = outcomes.device
    rows = torch.arange(k, device=dev)
    jobs = torch.arange(n, device=dev)[None, :]
    outcomes = outcomes.to(torch.int64)
    stage = torch.zeros((k, n), dtype=torch.int64, device=dev)
    clock = torch.zeros(k, dtype=torch.float64, device=dev)
    tdone = torch.zeros((k, n), dtype=torch.float64, device=dev)
    done = torch.zeros((k, n), dtype=torch.bool, device=dev)
    for _ in range(total_stages):
        alive = ~done
        idx = torch.where(alive, idx_table[jobs, stage.clamp(max=m - 1)], torch.inf)
        any_alive = alive.any(dim=1)
        j = torch.argmin(idx, dim=1)
        sj = stage[rows, j]
        clock = clock + torch.where(any_alive, stage_durs[j, sj.clamp(max=m - 1)], 0.0)
        newly_done = any_alive & (sj >= outcomes[rows, j])
        stage[rows, j] = sj + any_alive.to(torch.int64)
        tdone[rows, j] = torch.where(newly_done, clock, tdone[rows, j])
        done[rows, j] |= newly_done
    cnt = success.sum(dim=1)
    tot = (tdone * success).sum(dim=1)
    return weights @ torch.where(cnt > 0, tot / cnt.clamp(min=1), 0.0)


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
    With ``outcomes=None`` and ``samples=None`` the evaluation is exact:
    all ``prod(M_i)`` combinations are enumerated inside the kernel (up
    to ``MAX_EXACT_COMBOS``).  Explicit ``outcomes``/``weights`` (samples
    or a shared exact table) go through the ``sojourn_outcomes`` kernel;
    ``samples=(seed, n_samples)`` runs streaming Monte Carlo.  Returns a
    float for one order, a (P,) array for a batch, and ``(e_succ,
    e_all)`` with ``also_all_jobs``.
    """
    with profiling.span("entry.plan.static"):
        orders = np.asarray(orders, dtype=np.int32)
        single = orders.ndim == 1
        if single:
            orders = orders[None]
        sizes, probs, num_stages = policies.padded_arrays(jobs)
        if samples is None and outcomes is None:
            _check_exact(jobs)
    e_succ, e_all = sojourn_eval(
        sizes, probs, num_stages, orders, outcomes=outcomes, weights=weights,
        samples=samples, device=device,
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
    ``n_servers=W`` evaluates the paper's multi-server setting.  Explicit
    ``outcomes``/``weights`` run :func:`_dynamic_batch` on one server
    (``n_servers > 1`` raises there).
    """
    with profiling.span(f"entry.plan.{policy}"):
        _, probs, num_stages = policies.padded_arrays(jobs)
        idx_table = policies.index_table(jobs, policy)
        stage_durs = policies.stage_durations(jobs)
        if samples is None and outcomes is None:
            _check_exact(jobs)
    if samples is not None or outcomes is None:
        e_succ, _ = sojourn_eval_dynamic(
            probs, stage_durs, num_stages, idx_table,
            samples=samples, n_servers=n_servers, device=device,
        )
        return float(e_succ[0])
    if n_servers != 1:
        raise ValueError(
            "the materialized outcomes/weights tier is single-server; "
            "use the fused path (outcomes=None or samples=) for n_servers > 1"
        )
    dev = resolve_device(device)
    _, success = _realized_arrays(jobs, outcomes)
    val = _dynamic_batch(
        torch.tensor(idx_table, dtype=torch.float64, device=dev),
        torch.tensor(stage_durs, dtype=torch.float64, device=dev),
        torch.as_tensor(np.asarray(outcomes), device=dev),
        torch.as_tensor(success, device=dev),
        torch.as_tensor(np.asarray(weights, dtype=np.float64), device=dev),
        int(num_stages.sum()),
    )
    return float(val)


def optimal_order(
    jobs: Workload, max_n: int = 9, device=None
) -> tuple[np.ndarray, float]:
    """Exhaustive search over all N! non-preemptive orders (Thm III.1)."""
    n = len(jobs)
    if n > max_n:
        raise ValueError(f"exhaustive search with N={n} > {max_n} is too expensive")
    with profiling.span("entry.plan.optimal"):
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
    if policy in ("rank", "random"):
        if policy == "random" and rng is None:
            raise ValueError("random policy needs an rng")
        with profiling.span(f"entry.plan.{policy}"):
            order = (policies.rank_order(jobs) if policy == "rank"
                     else policies.random_order(jobs, rng))
        return expected_sojourn_static(
            jobs, order, outcomes, weights, samples=samples, device=device
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
    with profiling.span("entry.plan.group"):
        exact = exact_combination_count(jobs) <= MAX_EXACT_COMBOS
        seed = None if exact else int(rng.integers(0, kernel_rng.MAX_SEED))
    if exact:
        return {alg: evaluate(jobs, alg, rng=rng, device=device) for alg in algs}
    return {
        alg: evaluate(jobs, alg, rng=rng, samples=(seed, mc_samples), device=device)
        for alg in algs
    }
