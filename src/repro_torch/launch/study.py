"""The paper's studies on the port: one function per table or figure.

The counterpart of ``benchmarks/run.py`` (the reference's harness), with
the same seeds, the same shared ``rng`` and the same row keys:

  fig1_objective_gap   -> Figure 1   (all-jobs vs successful-jobs objective)
  table_sojourn        -> Tables IV-VIII (mean sojourn, workload sets 1-5)
  table_competitive    -> Tables IX-XIII (max/p95/p75 competitive ratios)
  table_stages         -> Table XIV  (stage-count sweep)
  table_trace          -> Tables XVI-XVIII (trace-driven online study)
  table_faults         -> policy robustness under failures and resizes

The numerical study (Figure 1, Tables IV-XIV) is thousands of
``evaluate_many`` calls at N = 3-8 jobs; they run on the CUDA card
(``sojourn_enum`` for OPTIMAL, RANK and RANDOM, ``dynamic_sojourn_enum``
for SR and SERPT) unless ``--device cpu`` selects the plain PyTorch
versions.  The trace and fault studies run the discrete-event engine on
the host, as the reference does.

Default is a CI-friendly scale (fewer trials, a load-matched subsampled
trace); ``--full`` is paper scale (50,000 trials a (set, N), 109,967
trace jobs).  Each table prints as markdown and is written to
``--out`` (default ``artifacts/bench_torch``) as
``{"rows": ..., "workload_cache": ...}``::

    python -m repro_torch.launch.study --table sojourn          # on the card
    python -m repro_torch.launch.study --table all --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from repro_torch.configs.paper_workloads import NUMERICAL, TRACE
from repro_torch.core import policies
from repro_torch.core.evaluator import evaluate_many
from repro_torch.core.jobs import generate_workload
from repro_torch.core.simulator import simulate
from repro_torch.core.trace import synthesize_trace

__all__ = [
    "OUT",
    "TABLES",
    "fig1_objective_gap",
    "table_sojourn",
    "table_competitive",
    "table_stages",
    "table_trace",
    "table_faults",
    "main",
]

#: Default output directory, beside the reference's ``artifacts/bench``.
OUT = os.path.join("artifacts", "bench_torch")

STUDY_ALGS = ("optimal", "rank", "serpt", "sr", "random")


def _save(name: str, obj, out: str) -> None:
    """Write ``<out>/<name>.json`` as ``{"rows": ..., "workload_cache": ...}``,
    so every artifact records the workload-keyed cache behavior of the run
    that produced it."""
    if not isinstance(obj, dict):
        obj = {"rows": obj}
    obj = {**obj, "workload_cache": policies.cache_stats()}
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{name}.json"), "w") as f:
        json.dump(obj, f, indent=1)


def _trials_for(n_jobs: int, full: bool) -> int:
    if full:
        return NUMERICAL.trials
    return {3: 400, 4: 400, 5: 300, 6: 200, 7: 120, 8: 60}.get(n_jobs, 200)


# ---------------------------------------------------------------------------
# Figure 1
# ---------------------------------------------------------------------------


def fig1_objective_gap(full: bool = False, device=None, out: str = OUT):
    """Mean sojourn of successful jobs: optimize-for-all (SR) vs
    optimize-for-successful (RANK), vs number of jobs."""
    rows = []
    rng = np.random.default_rng(42)
    for n in (3, 4, 5, 6, 7, 8, 9, 10):
        trials = _trials_for(min(n, 8), full)
        vals = {"rank": [], "sr": []}
        for _ in range(trials):
            jobs = generate_workload(rng, n, workload_set=1)
            res = evaluate_many(jobs, ("rank", "sr"), rng, device=device)
            for k in vals:
                vals[k].append(res[k])
        rows.append({
            "n_jobs": n,
            "optimize_successful(RANK)": float(np.mean(vals["rank"])),
            "optimize_all(SR)": float(np.mean(vals["sr"])),
            "gap_pct": 100 * (np.mean(vals["sr"]) / np.mean(vals["rank"]) - 1),
        })
    _save("fig1", rows, out)
    return rows


# ---------------------------------------------------------------------------
# Tables IV-VIII and IX-XIII
# ---------------------------------------------------------------------------


def _numerical_study(full: bool, sets=None, n_jobs=None, device=None):
    """Shared sweep: per (workload set, N): mean sojourn per algorithm and
    competitive ratios against OPTIMAL."""
    sets = sets or NUMERICAL.workload_sets
    n_jobs = n_jobs or NUMERICAL.n_jobs_sweep
    out = {}
    rng = np.random.default_rng(7)
    for ws in sets:
        for n in n_jobs:
            trials = _trials_for(n, full)
            vals = {a: np.empty(trials) for a in STUDY_ALGS}
            for t in range(trials):
                jobs = generate_workload(rng, n, num_stages=NUMERICAL.num_stages,
                                         workload_set=ws)
                res = evaluate_many(jobs, STUDY_ALGS, rng, device=device)
                for a in STUDY_ALGS:
                    vals[a][t] = res[a]
            cr = {a: vals[a] / vals["optimal"] for a in STUDY_ALGS if a != "optimal"}
            out[(ws, n)] = {
                "mean": {a: float(vals[a].mean()) for a in STUDY_ALGS},
                "stderr": {a: float(vals[a].std() / np.sqrt(trials)) for a in STUDY_ALGS},
                "cr_max": {a: float(v.max()) for a, v in cr.items()},
                "cr_p95": {a: float(np.percentile(v, 95)) for a, v in cr.items()},
                "cr_p75": {a: float(np.percentile(v, 75)) for a, v in cr.items()},
                "trials": trials,
            }
    return out


def table_sojourn(full: bool = False, study=None, device=None, out: str = OUT):
    """Tables IV-VIII: average expected sojourn of successful jobs."""
    study = study or _numerical_study(full, device=device)
    rows = []
    for (ws, n), r in sorted(study.items()):
        rows.append({
            "workload_set": ws, "n_jobs": n, "trials": r["trials"],
            **{a: r["mean"][a] for a in STUDY_ALGS},
            "rank_vs_optimal_pct": 100 * (r["mean"]["rank"] / r["mean"]["optimal"] - 1),
        })
    _save("table_sojourn", rows, out)
    return rows


def table_competitive(full: bool = False, study=None, device=None, out: str = OUT):
    """Tables IX-XIII: competitive-ratio max / p95 / p75."""
    study = study or _numerical_study(full, device=device)
    rows = []
    for (ws, n), r in sorted(study.items()):
        for metric in ("cr_max", "cr_p95", "cr_p75"):
            rows.append({
                "workload_set": ws, "n_jobs": n, "metric": metric,
                **{a: r[metric][a] for a in ("rank", "serpt", "sr", "random")},
            })
    _save("table_competitive", rows, out)
    return rows


def table_stages(full: bool = False, device=None, out: str = OUT):
    """Table XIV: stage-count sweep at N=5, uniform set."""
    rows = []
    rng = np.random.default_rng(11)
    n = 5
    for m in NUMERICAL.stages_sweep:
        trials = _trials_for(n, full)
        vals = {"optimal": np.empty(trials), "rank": np.empty(trials)}
        crs = np.empty(trials)
        for t in range(trials):
            jobs = generate_workload(rng, n, num_stages=m, workload_set=1)
            res = evaluate_many(jobs, ("optimal", "rank"), rng, device=device)
            vals["optimal"][t] = res["optimal"]
            vals["rank"][t] = res["rank"]
            crs[t] = res["rank"] / res["optimal"]
        rows.append({
            "num_stages": m, "trials": trials,
            "optimal": float(vals["optimal"].mean()),
            "rank": float(vals["rank"].mean()),
            "max_cr": float(crs.max()),
        })
    _save("table_stages", rows, out)
    return rows


# ---------------------------------------------------------------------------
# Tables XVI-XVIII: trace-driven online study (host)
# ---------------------------------------------------------------------------


def table_trace(full: bool = False, out: str = OUT):
    rows = []
    n_jobs = TRACE.n_jobs if full else TRACE.n_jobs_fast
    duration = TRACE.duration_days * (n_jobs / TRACE.n_jobs)  # load-matched
    for sp in TRACE.synthetic_success_probs:
        dataset = {None: "philly-synthetic", 0.5: "synthetic-I", 0.25: "synthetic-II"}[sp]
        rng = np.random.default_rng(13)
        jobs = synthesize_trace(rng, n_jobs=n_jobs, duration_days=duration,
                                success_prob=sp)
        for w in TRACE.server_counts:
            row = {"dataset": dataset, "servers": w}
            for pol in TRACE.policies:
                res = simulate(jobs, w, policy=pol, rng=np.random.default_rng(17))
                row[pol] = res.mean_sojourn_successful
                row[f"{pol}_nsucc"] = res.n_success
            row["rank_vs_serpt_pct"] = 100 * (1 - row["rank"] / row["serpt"])
            rows.append(row)
    _save("table_trace", rows, out)
    return rows


# ---------------------------------------------------------------------------
# Beyond the paper: policy robustness under failures / stragglers / elasticity
# ---------------------------------------------------------------------------


def table_faults(full: bool = False, out: str = OUT):
    """RANK's advantage must survive the failure modes of a real cluster
    (the paper's model is failure-free).  Same trace-style workload, now
    with node failures (gang restart from checkpoint), straggler
    re-dispatch, and an elastic resize mid-run."""
    from repro_torch.cluster.faults import FaultConfig
    from repro_torch.cluster.manager import ClusterManager, TrainingJob

    n = 2000 if not full else 10000
    servers = 8
    rng = np.random.default_rng(21)
    # offered load ~2x capacity: queueing decisions matter
    arrivals = np.sort(rng.uniform(0, n * 0.75 / (2 * servers), n))
    base_jobs = generate_workload(rng, n, num_stages=3, workload_set=1,
                                  arrivals=arrivals)
    scenarios = {
        "clean": dict(fault_cfg=None),
        "faulty": dict(fault_cfg=FaultConfig(mtbf_hours=0.002, restart_overhead=0.5,
                                             straggler_prob=0.05,
                                             straggler_slowdown=5.0),
                       nodes_per_server=8),
        "elastic": dict(fault_cfg=None,
                        resize_events=[(20.0, 12), (60.0, 4)]),
    }
    rows = []
    for scen, kw in scenarios.items():
        row = {"scenario": scen}
        for pol in ("rank", "serpt", "sr", "fifo"):
            jobs = [TrainingJob(spec=s) for s in base_jobs]
            res = ClusterManager(jobs, servers, policy=pol,
                                 rng=np.random.default_rng(5), **kw).run()
            row[pol] = res.mean_sojourn_successful
            if pol == "rank":
                row["restarts"] = res.restarts
                row["straggler_redisp"] = res.straggler_redispatches
        row["rank_vs_serpt_pct"] = 100 * (1 - row["rank"] / row["serpt"])
        rows.append(row)
    _save("table_faults", rows, out)
    return rows


# ---------------------------------------------------------------------------


def _fmt(rows: list[dict]) -> str:
    if not rows:
        return "  (empty)"
    keys = list(rows[0].keys())
    head = "| " + " | ".join(keys) + " |"
    sep = "|" + "---|" * len(keys)
    body = []
    for r in rows:
        body.append(
            "| " + " | ".join(
                f"{r[k]:.4g}" if isinstance(r[k], float) else str(r[k]) for k in keys
            ) + " |"
        )
    return "\n".join([head, sep] + body)


TABLES = {
    "fig1": fig1_objective_gap,
    "sojourn": table_sojourn,
    "competitive": table_competitive,
    "stages": table_stages,
    "trace": table_trace,
    "faults": table_faults,
}

#: Tables whose evaluations run on ``--device``; the rest are host code.
ON_DEVICE = ("fig1", "sojourn", "competitive", "stages")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.study", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--table", default="all", choices=["all", *TABLES])
    ap.add_argument("--full", action="store_true", help="paper-scale trials")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="persist the workload-keyed memo tier in DIR "
                         "(overrides REPRO_CACHE_DIR)")
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain PyTorch versions; default: the CUDA card")
    ap.add_argument("--out", default=OUT, help="directory of the JSON artifacts")
    args = ap.parse_args(argv)

    names = list(TABLES) if args.table == "all" else [args.table]
    if any(name in ON_DEVICE for name in names):
        from repro_torch.device import resolve_device

        dev = resolve_device(args.device)
        if dev.type == "cuda":
            import torch

            print(f"device: {dev} ({torch.cuda.get_device_name(dev)})")
        else:
            print(f"device: {dev} (plain PyTorch versions of the kernels)")
    if args.cache_dir:
        os.environ["REPRO_CACHE_DIR"] = args.cache_dir
        print(f"workload cache dir: {policies.ensure_cache_dir()}")
    elif args.full:
        # Paper-scale sweeps revisit the same workloads across tables and
        # reruns: persist the workload-keyed memo tier unless the user
        # already pointed REPRO_CACHE_DIR somewhere.
        print(f"workload cache dir: {policies.ensure_cache_dir()}")

    shared_study = None
    for name in names:
        kw = {"full": args.full, "out": args.out}
        if name in ON_DEVICE:
            kw["device"] = args.device
        t0 = time.perf_counter()
        if name in ("sojourn", "competitive") and args.table == "all":
            if shared_study is None:
                shared_study = _numerical_study(args.full, device=args.device)
            kw["study"] = shared_study
        rows = TABLES[name](**kw)
        dt = time.perf_counter() - t0
        print(f"\n## {name}  ({dt:.1f}s)")
        print(_fmt(rows))

    stats = policies.cache_stats()
    print(
        f"\nworkload cache: {stats['hits']} hits / {stats['misses']} misses "
        f"(hit rate {stats['hit_rate']:.1%}, {stats['entries']} entries)"
    )


if __name__ == "__main__":
    main()
