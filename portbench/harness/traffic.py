"""The general traffic generator: job groups as the paper draws them.

A frozen copy of the paper's generator (Section IV-A2, Table III), drawn
in bulk: every group of one size and workload set in a few NumPy calls.
A configuration names its workload sets (the distributions of the
stage-size increments and of the final success probability) and the stage
count M; a traffic file names one block of groups, ``[N, set, groups]``
entries, and the window's groups run through that block again and again,
each time in another order drawn from the seed, so that every seed gives
the same mix of sizes.  Job i of a group has cumulative sizes
``cumsum(max(increments, 1e-9))`` and stop probabilities ``(1 - p) w`` over
its M - 1 checkpoints (``w`` a symmetric Dirichlet draw, which the paper's
stage sweep of Table XIV needs; for M = 2 just ``1 - p``) and ``p`` at
success.  For one group the draws are in the order of the program's own
``generate_workload``, so one seed gives its arrays too.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DIST_I", "DIST_II", "draw_groups", "sequence"]

#: Final-success-probability distributions I and II (the paper's Tables I, II):
#: (values, shares).
DIST_I = (np.arange(0.1, 1.0, 0.1), np.array([0.2, 0.15, 0.1, 0.05, 0.0, 0.05, 0.1, 0.15, 0.2]))
DIST_II = (np.arange(0.1, 1.0, 0.1),
           np.array([0.025, 0.05, 0.1, 0.15, 0.35, 0.15, 0.1, 0.05, 0.025]))


def _increments(rng, shape, kind: str) -> np.ndarray:
    if kind == "uniform":
        return rng.uniform(0.0, 1.0, size=shape)
    if kind == "exp":
        return rng.exponential(1.0, size=shape)
    if kind == "weibull":
        return rng.weibull(0.5, size=shape)
    raise ValueError(f"unknown stage-size distribution {kind!r}")


def _success(rng, shape, kind: str) -> np.ndarray:
    if kind == "uniform":
        return rng.uniform(1e-5, 1 - 1e-5, size=shape)
    table = {"dist1": DIST_I, "dist2": DIST_II}.get(kind)
    if table is None:
        raise ValueError(f"unknown success-probability distribution {kind!r}")
    values, shares = table
    return rng.choice(values, size=shape, p=shares / shares.sum())


def draw_groups(rng: np.random.Generator, n_groups: int, n_jobs: int, num_stages: int,
                stage_sizes: str, success_probs: str) -> tuple[np.ndarray, np.ndarray]:
    """``(sizes, probs)``, each (G, N, M) float64, of ``n_groups`` groups of
    ``n_jobs`` jobs, M >= 2."""
    if num_stages < 2:
        raise ValueError("a job has a checkpoint and a success: M >= 2")
    shape = (n_groups, n_jobs)
    sizes = np.cumsum(np.maximum(_increments(rng, (*shape, num_stages), stage_sizes), 1e-9),
                      axis=2)
    p = _success(rng, shape, success_probs)
    if num_stages == 2:
        probs = np.stack([1.0 - p, p], axis=2)
    else:
        w = rng.dirichlet(np.ones(num_stages - 1), size=shape)
        probs = np.concatenate([(1.0 - p)[..., None] * w, p[..., None]], axis=2)
    return sizes, probs


def sequence(rng: np.random.Generator, n_groups: int, block) -> list[tuple[int, int]]:
    """``n_groups`` keys ``(N, workload set)``: the block's entries, each
    ``[N, set, groups]``, shuffled, then shuffled again, until there are
    enough."""
    keys = [(int(n), int(ws)) for n, ws, count in block for _ in range(int(count))]
    out: list[tuple[int, int]] = []
    while len(out) < n_groups:
        out.extend(keys[i] for i in rng.permutation(len(keys)))
    return out[:n_groups]
