"""Dense oracles for the fused sojourn evaluators, in PyTorch.

The counterpart of ``repro/kernels/sojourn_eval/ref.py``.  It
materializes the full ``(K, N)`` decoded outcome matrix (so it is only
usable at small K) and evaluates every order against it with the exact
math of the paper's Eqs. (7)-(9).

``ref_sojourn_dynamic`` is the oracle for stage-level index policies
(SR / SERPT / conditional-RANK): a deliberately naive per-combination
Python simulation of W-server stage-boundary preemption, structured as a
loop over server decisions so that it shares no code with the lockstep
paths it checks.

``ref_mc_outcomes`` replays the streaming-Monte-Carlo counter stream on
the host (NumPy Threefry, :mod:`repro_torch.kernels.sojourn_eval.rng`)
into a dense ``(S, N)`` table that matches the in-kernel stream bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.sojourn_eval import rng

__all__ = [
    "mixed_radix_strides",
    "ref_decode",
    "ref_mc_outcomes",
    "ref_sojourn",
    "ref_sojourn_dynamic",
]


def mixed_radix_strides(num_stages: np.ndarray) -> np.ndarray:
    """Strides s.t. ``stage_i(k) = (k // stride_i) % M_i``; job 0 is the
    most-significant digit (matches ``np.meshgrid(..., indexing="ij")``)."""
    rev = np.cumprod(np.asarray(num_stages, dtype=np.int64)[::-1])[::-1]
    return np.concatenate([rev[1:], [1]])


def ref_decode(num_stages: np.ndarray, k_total: int) -> np.ndarray:
    """(K, N) decoded stop-stage matrix for all combinations."""
    strides = mixed_radix_strides(num_stages)
    k = np.arange(k_total, dtype=np.int64)
    return ((k[:, None] // strides[None, :]) % np.asarray(num_stages)[None, :]).astype(
        np.int32
    )


def ref_mc_outcomes(
    probs: np.ndarray,  # (N, M) padded stop probabilities
    num_stages: np.ndarray,  # (N,) stage counts
    seed: int,
    n_samples: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Dense host replay of the streamed-MC outcome stream.

    Returns ``(outcomes (S, N) int32, weights (S,) = 1/S)``, bitwise the
    outcomes the streaming kernels decode for the same ``(seed, n_samples)``.
    """
    outcomes = rng.host_outcomes(seed, n_samples, probs, num_stages)
    weights = np.full((n_samples,), 1.0 / n_samples)
    return outcomes, weights


def ref_sojourn(
    sizes,  # (N, M) padded cumulative sizes
    probs,  # (N, M) padded stop probabilities
    num_stages,  # (N,) stage counts
    orders,  # (P, N) permutations
    outcomes=None,  # optional (K, N) explicit outcome matrix
    weights=None,  # optional (K,) combination weights
) -> tuple[torch.Tensor, torch.Tensor]:
    """(E[sojourn successful], E[sojourn all]) per order, dense, float64."""
    sizes = torch.tensor(np.asarray(sizes, dtype=np.float64))
    num_stages = np.asarray(num_stages)
    n = sizes.shape[0]
    if outcomes is None:
        k_total = int(np.prod(num_stages, dtype=np.int64))
        outcomes = ref_decode(num_stages, k_total)
        weights = np.prod(
            np.asarray(probs, dtype=np.float64)[np.arange(n)[None, :], outcomes],
            axis=1,
        )
    outcomes = torch.tensor(np.asarray(outcomes, dtype=np.int64))
    weights = torch.tensor(np.asarray(weights, dtype=np.float64))
    d = sizes[torch.arange(n)[None, :], outcomes]  # (K, N)
    succ = outcomes == torch.tensor(num_stages)[None, :] - 1
    cnt = succ.sum(dim=1)
    e_succ, e_all = [], []
    for order in np.asarray(orders, dtype=np.int64):
        order = torch.as_tensor(order)
        t = torch.cumsum(d[:, order], dim=1)
        tot = (t * succ[:, order]).sum(dim=1)
        mean = torch.where(cnt > 0, tot / cnt.clamp(min=1), 0.0)
        e_succ.append(weights @ mean)
        e_all.append(weights @ t.mean(dim=1))
    return torch.stack(e_succ), torch.stack(e_all)


def ref_sojourn_dynamic(
    probs,  # (N, M) padded stop probabilities
    stage_durs,  # (N, M) padded per-stage service increments
    num_stages,  # (N,) stage counts
    idx_table,  # (N, M) conditional index table (+inf pad)
    outcomes=None,  # optional (K, N) explicit outcome matrix
    weights=None,  # optional (K,) combination weights
    n_servers=1,  # W homogeneous servers
) -> tuple[float, float]:
    """(E[sojourn successful], E[sojourn all]) for one index policy, dense.

    Per combination: while a server is free, seat the alive unserved job
    with the minimum conditional index (ties to the lowest job
    position); then advance to the earliest finishing segment (ties to
    the lowest job position) and either record the job's completion (it
    reached its decoded outcome stage) or requeue it at its next
    conditional index.  Success == stopping at the last stage.
    """
    probs = np.asarray(probs, dtype=np.float64)
    stage_durs = np.asarray(stage_durs, dtype=np.float64)
    num_stages = np.asarray(num_stages)
    idx_table = np.asarray(idx_table, dtype=np.float64)
    n = len(num_stages)
    if outcomes is None:
        k_total = int(np.prod(num_stages, dtype=np.int64))
        outcomes = ref_decode(num_stages, k_total)
        weights = np.prod(probs[np.arange(n)[None, :], outcomes], axis=1)
    e_succ = 0.0
    e_all = 0.0
    for outcome, w in zip(np.asarray(outcomes), np.asarray(weights)):
        stage = [0] * n
        done = [False] * n
        completion = [0.0] * n
        finish: dict[int, float] = {}  # job -> busy-until
        clock = 0.0
        while not all(done):
            while len(finish) < n_servers:
                best, best_j = np.inf, -1
                for j in range(n):
                    if done[j] or j in finish:
                        continue
                    if idx_table[j, stage[j]] < best:
                        best, best_j = idx_table[j, stage[j]], j
                if best_j < 0:
                    break  # queue empty: leave servers idle
                finish[best_j] = clock + stage_durs[best_j, stage[best_j]]
            j = min(finish, key=lambda q: (finish[q], q))
            clock = finish.pop(j)
            if stage[j] == outcome[j]:
                done[j] = True
                completion[j] = clock
            else:
                stage[j] += 1
        succ = [j for j in range(n) if outcome[j] == num_stages[j] - 1]
        if succ:
            e_succ += w * float(np.mean([completion[j] for j in succ]))
        e_all += w * float(np.mean(completion))
    return e_succ, e_all
