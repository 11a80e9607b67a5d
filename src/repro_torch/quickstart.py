"""Quickstart: the paper's contribution, evaluated on the CUDA card.

The counterpart of ``examples/quickstart.py``.  Replays the worked
example of paper §III-A, then compares RANK (paper Eq. 23) against
SERPT / SR (Gittins) / RANDOM / OPTIMAL on the exact expected sojourn
time of *successful* jobs for a small random workload.

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

The default device is the CUDA card (the first call builds the kernels
with ``nvcc``); ``--device cpu`` runs the plain PyTorch versions.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.evaluator import evaluate, evaluate_many, optimal_order
from repro_torch.core.jobs import JobSpec, generate_workload
from repro_torch.core.policies import erpt_values, rank_values, sr_rank_values
from repro_torch.obs import format_snapshot, get_registry, profiling


def worked_example(device=None) -> None:
    """Paper §III-A: two jobs where SR=10, SERPT=9.75, OPTIMAL=9.1."""
    jobs = [
        JobSpec(sizes=np.array([1.0, 10.0]), probs=np.array([0.25, 0.75])),
        JobSpec(sizes=np.array([3.0, 6.0]), probs=np.array([0.6, 0.4])),
    ]
    print("== Paper §III-A worked example ==")
    print(f"  SR (Gittins)      : {evaluate(jobs, 'sr', device=device):.4f}   (paper: 10)")
    print(f"  SERPT             : {evaluate(jobs, 'serpt', device=device):.4f} (paper: 9.75)")
    order, val = optimal_order(jobs, device=device)
    print(f"  OPTIMAL {order}   : {val:.4f}  (paper: 9.1)")
    print(f"  RANK values       : {rank_values(jobs)} -> job {np.argmin(rank_values(jobs))} first")


def random_workload(device=None) -> None:
    rng = np.random.default_rng(0)
    jobs = generate_workload(rng, n_jobs=7, num_stages=3, workload_set=1)
    print("\n== 7 random 3-stage jobs (workload set 1) ==")
    print(f"  rank  R(i) : {np.round(rank_values(jobs), 3)}")
    print(f"  ERPT       : {np.round(erpt_values(jobs), 3)}")
    print(f"  SR rank    : {np.round(sr_rank_values(jobs), 3)}")
    res = evaluate_many(
        jobs, ("optimal", "rank", "serpt", "sr", "random"), rng, device=device
    )
    print("  expected sojourn of successful jobs:")
    for k, v in sorted(res.items(), key=lambda kv: kv[1]):
        print(f"    {k:8s} {v:.4f}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    profiling.enable()  # time the fused evaluator ops + cache tiers
    worked_example(args.device)
    random_workload(args.device)
    print()
    print(format_snapshot(get_registry().snapshot(), title="profiling"))


if __name__ == "__main__":
    main()
