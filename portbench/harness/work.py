"""What a group's evaluation needs of the card, from the frozen counts.

A policy whose reference ``KIND`` is ``order`` is a static order, one of
``optimum`` the best of many orders, one of ``index`` a stage-level index
table; the configuration's ``counts`` names the kernel, and so the file
``counts/<kernel>.py``, whose work each kind is.  A policy evaluates one
order or table, or as many as its reference file's ``evaluations(N)``
says.  A kernel's work in a group is the sum over its policies; its stream
counts once a launch.  The whole group's least time counts the stream
once, since every policy shares it.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.evaluator import load_policy

def evaluations_by_kernel(config: dict, n_jobs: int) -> dict[str, int]:
    """``{kernel: orders or tables of the configuration's policies that it
    evaluates}`` for a group of ``n_jobs`` jobs."""
    out: dict[str, int] = {}
    for name in config["policies"]:
        pol = load_policy(name)
        kernel = config["counts"][pol.KIND]
        out[kernel] = out.get(kernel, 0) + int(getattr(pol, "evaluations", lambda n: 1)(n_jobs))
    return out


def group_work(cell, probs: np.ndarray) -> dict[str, dict]:
    """``{kernel: {"flops", "bytes", "stream"}}`` of one group (``probs``
    (N, M); every job has M stages)."""
    cfg = cell.config
    n, m = probs.shape
    num_stages = np.full(n, m)
    count = int(cfg["mc_samples"]) if cfg["evaluation"] == "monte_carlo" else m**n
    return {kernel: cell.count(kernel).work(probs, num_stages, n_evals, count)
            for kernel, n_evals in evaluations_by_kernel(cfg, n).items()}


def roofline_pct(window, kernel: str, pattern: str) -> float | None:
    """``kernel``'s share of its bound over the window: the least time of
    its work in every group (its stream once a launch) over the device time
    of the kernels whose name matches ``pattern``.  None when the trace has
    no such kernel or the program counted no launch of it."""
    if window.trace is None or window.peaks is None:
        return None
    seconds = window.trace.kernel_seconds(pattern)
    launches = window.launches.get(kernel, 0)
    if not seconds or not launches:
        return None
    per_group = launches / window.n_groups
    bound = 0.0
    for w in window.work:
        k = w.get(kernel)
        if k is not None:
            bound += window.peaks.least_seconds(k["flops"], k["bytes"], k["stream"] * per_group)
    return 100.0 * bound / seconds
