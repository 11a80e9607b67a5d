"""The paper's studies on the port: one function per table or figure.

The counterpart of ``benchmarks/run.py`` (the reference's harness), with
the same seeds, the same shared ``rng`` and the same row keys:

  fig1_objective_gap   -> Figure 1   (all-jobs vs successful-jobs objective)
  table_sojourn        -> Tables IV-VIII (mean sojourn, workload sets 1-5)
  table_competitive    -> Tables IX-XIII (max/p95/p75 competitive ratios)
  table_stages         -> Table XIV  (stage-count sweep)
  table_trace          -> Tables XVI-XVIII (trace-driven online study)
  table_faults         -> policy robustness under failures and resizes
  table_eval_perf      -> the seed (materialised) static evaluator vs the fused kernel
  table_eval_dynamic   -> the same for SR/SERPT on one server
  table_eval_mc        -> streamed Monte Carlo vs the materialised sample table
  table_roofline       -> the dry run's roofline terms, a row a (arch, shape, mesh)

The numerical study (Figure 1, Tables IV-XIV) is thousands of
``evaluate_many`` calls at N = 3-8 jobs; they run on the CUDA card
(``sojourn_enum`` for OPTIMAL, RANK and RANDOM, ``dynamic_sojourn_enum``
for SR and SERPT) unless ``--device cpu`` selects the plain PyTorch
versions.  The trace and fault studies run the discrete-event engine on
the host, as the reference does.  The three ``table_eval_*`` tables time
the fused kernels (``sojourn_enum``, ``dynamic_sojourn_enum``,
``sojourn_mc``) against the seed design's host-built tables reduced by
plain PyTorch (``sojourn_outcomes`` for the sampled table) on the same
device, and keep the reference's own checks: fused against seed within
1e-9, the streamed estimate within 3 sigma of the exact value, and
(unless ``smoke``) the streamed path at least twice the materialised
one's throughput.  ``n_jobs`` makes them small for tests.

Default is a CI-friendly scale (fewer trials, a load-matched subsampled
trace); ``--full`` is paper scale (50,000 trials a (set, N), 109,967
trace jobs).  Each table prints as markdown and is written to
``--out`` (default ``artifacts/bench_torch``) as
``{"rows": ..., "workload_cache": ...}``::

    python -m repro_torch.launch.study --table sojourn          # on the card
    python -m repro_torch.launch.study --table eval_mc --smoke --device cpu
    python -m repro_torch.launch.study --table roofline   # after launch.dryrun

``table_roofline`` reads ``artifacts/dryrun_torch/*.json`` (what
``python -m repro_torch.launch.dryrun`` writes), never the reference's
``artifacts/dryrun``; its terms model a machine of H100 cards and are not
measurements (:mod:`repro_torch.launch.roofline`).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs.paper_workloads import NUMERICAL, TRACE
from repro_torch.core import evaluator, policies
from repro_torch.core.evaluator import evaluate_many
from repro_torch.core.jobs import generate_workload
from repro_torch.core.simulator import simulate
from repro_torch.core.trace import synthesize_trace
from repro_torch.device import resolve_device

__all__ = [
    "OUT",
    "TABLES",
    "fig1_objective_gap",
    "table_sojourn",
    "table_competitive",
    "table_stages",
    "table_trace",
    "table_faults",
    "table_eval_perf",
    "table_eval_dynamic",
    "table_eval_mc",
    "table_roofline",
    "main",
]

#: Default output directory, beside the reference's ``artifacts/bench``.
OUT = os.path.join("artifacts", "bench_torch")
#: Where ``python -m repro_torch.launch.dryrun`` writes its cells.
DRYRUN = os.path.join("artifacts", "dryrun_torch")

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
# The fused evaluator against the seed design (BENCH_eval*.json)
# ---------------------------------------------------------------------------


def _median_after_warmup(fn, repeats: int):
    """(median wall seconds of ``repeats`` calls after one warm-up call,
    the last call's result)."""
    ts = []
    for _ in range(repeats + 1):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts[1:])), out


def table_eval_perf(full: bool = False, device=None, out: str = OUT, n_jobs: int = 21):
    """Seed materialised evaluator vs the fused streaming op.

    The seed path builds the (K, N) outcome/duration/success tables on the
    host and reduces them with ``evaluator._static_batch`` (plain PyTorch
    on ``device``); the fused path (``sojourn_enum`` on the card) decodes
    combinations on the fly and never materialises them.  Timed at K =
    2**21 (``n_jobs=21``, the seed's exact-eval cap); ``--full`` adds a
    fused-only row at K = 2**26.
    """
    dev = resolve_device(device)

    def seed_call(jobs, orders):
        # per-call work in the seed design: materialise + gather + reduce
        outcomes, weights = evaluator.enumerate_outcomes(jobs)
        durations, success = evaluator._realized_arrays(jobs, outcomes)
        return evaluator._static_batch(
            torch.tensor(durations, dtype=torch.float64, device=dev),
            torch.as_tensor(success, device=dev),
            torch.as_tensor(weights, dtype=torch.float64, device=dev),
            torch.as_tensor(orders, device=dev),
        ).cpu().numpy()

    rows = []
    rng = np.random.default_rng(31)
    repeats = 5 if full else 3

    n = n_jobs  # M=2 -> K = 2**21 at the default, the seed cap
    jobs = generate_workload(rng, n)
    orders = np.stack([policies.rank_order(jobs),
                       rng.permutation(n).astype(np.int32)])
    t_fused, v_fused = _median_after_warmup(
        lambda: np.asarray(evaluator.expected_sojourn_static(jobs, orders, device=device)),
        repeats)
    t_seed, v_seed = _median_after_warmup(lambda: seed_call(jobs, orders), repeats)
    relerr = float(np.max(np.abs(v_fused - v_seed) / np.abs(v_seed)))
    assert relerr <= 1e-9, f"fused/seed divergence: {relerr}"
    rows.append({
        "k_combos": 1 << n, "n_jobs": n, "orders": len(orders),
        "seed_s": t_seed, "fused_s": t_fused,
        "speedup": t_seed / t_fused, "max_relerr_vs_seed": relerr,
    })

    if full:  # beyond the seed's representable range: fused only
        n = 26
        jobs = generate_workload(rng, n)
        orders = policies.rank_order(jobs)[None]
        t_fused, _ = _median_after_warmup(
            lambda: evaluator.expected_sojourn_static(jobs, orders, device=device), 1)
        rows.append({
            "k_combos": 1 << n, "n_jobs": n, "orders": 1,
            "seed_s": None, "fused_s": t_fused,
            "speedup": None, "max_relerr_vs_seed": None,
        })

    _save("BENCH_eval", rows, out)
    return rows


def table_eval_dynamic(full: bool = False, device=None, out: str = OUT, n_jobs: int = 21):
    """Seed materialised lockstep vs the fused dynamic op
    (BENCH_eval_dynamic).

    The seed design for SR/SERPT (``evaluator._dynamic_batch``) builds the
    (K, N) outcome/success tables on the host and simulates every
    combination in lockstep (plain PyTorch on ``device``); the fused op
    (``dynamic_sojourn_enum`` on the card) decodes combinations on the fly
    and simulates them in its threads.  Timed at K = 2**21; ``--full``
    adds SERPT and a fused-only row at K = 2**26.
    """
    dev = resolve_device(device)

    def seed_call(jobs, idx_table, stage_durs, total_stages):
        # per-call work in the seed design: materialise + gather + simulate
        outcomes, weights = evaluator.enumerate_outcomes(jobs)
        _, success = evaluator._realized_arrays(jobs, outcomes)
        return float(evaluator._dynamic_batch(
            torch.tensor(idx_table, dtype=torch.float64, device=dev),
            torch.tensor(stage_durs, dtype=torch.float64, device=dev),
            torch.as_tensor(outcomes, device=dev), torch.as_tensor(success, device=dev),
            torch.as_tensor(weights, dtype=torch.float64, device=dev), total_stages,
        ))

    rows = []
    rng = np.random.default_rng(37)
    repeats = 2 if full else 1
    policies_timed = ("sr", "serpt") if full else ("sr",)

    n = n_jobs  # M=2 -> K = 2**21 at the default, the materialisation cap
    jobs = generate_workload(rng, n)
    stage_durs = policies.stage_durations(jobs)
    total_stages = int(policies.padded_arrays(jobs)[2].sum())
    for policy in policies_timed:
        idx_table = policies.index_table(jobs, policy)
        t_fused, v_fused = _median_after_warmup(
            lambda: evaluator.expected_sojourn_dynamic(jobs, policy, device=device), repeats)
        t_seed, v_seed = _median_after_warmup(
            lambda: seed_call(jobs, idx_table, stage_durs, total_stages), repeats)
        relerr = abs(v_fused - v_seed) / abs(v_seed)
        assert relerr <= 1e-9, f"fused/seed divergence: {relerr}"
        rows.append({
            "k_combos": 1 << n, "n_jobs": n, "policy": policy,
            "seed_s": t_seed, "fused_s": t_fused,
            "speedup": t_seed / t_fused, "max_relerr_vs_seed": relerr,
        })

    if full:  # beyond the seed's representable range: fused only
        n = 26
        jobs = generate_workload(rng, n)
        t_fused, _ = _median_after_warmup(
            lambda: evaluator.expected_sojourn_dynamic(jobs, "sr", device=device), 1)
        rows.append({
            "k_combos": 1 << n, "n_jobs": n, "policy": "sr",
            "seed_s": None, "fused_s": t_fused,
            "speedup": None, "max_relerr_vs_seed": None,
        })

    _save("BENCH_eval_dynamic", {"rows": rows}, out)
    return rows


def table_eval_mc(full: bool = False, smoke: bool = False, device=None, out: str = OUT,
                  n_jobs: int = 27):
    """Streamed Monte Carlo vs the materialised sample-table path
    (BENCH_eval_mc).

    Beyond ``MAX_EXACT_COMBOS`` the evaluator estimates by Monte Carlo.
    The materialised design (``sample_outcomes`` + the explicit-outcomes
    op, ``sojourn_outcomes`` on the card) builds the (S, N) sample table
    on the host every call; the streamed design (``samples=(seed,
    n_samples)``, ``sojourn_mc`` on the card) draws outcomes inside the
    kernel from the Threefry counter stream.  Timed on a K = 2**27
    workload (``n_jobs=27``): streamed at 2**23 samples vs materialised at
    2**21 — the streamed path must be >= 2x the throughput at 4x the
    samples.  A small-K control checks the streamed estimate against the
    exact enumeration within 3-sigma CLT bounds (sigma replayed on the
    host from the same stream).  ``smoke`` shrinks the sample counts and
    drops the throughput bar; the kernels still run on the card.
    """
    from repro_torch.kernels.sojourn_eval.ref import ref_mc_outcomes

    seed = 0x5EED
    rng = np.random.default_rng(43)

    # --- small-K control: streamed estimate vs exact, CLT bound ----------
    ctrl_samples = 1 << (12 if smoke else 16)
    ctrl_jobs = generate_workload(rng, 8)  # K = 256
    order = policies.rank_order(ctrl_jobs)
    exact = evaluator.expected_sojourn_static(ctrl_jobs, order, device=device)
    est = evaluator.expected_sojourn_static(ctrl_jobs, order, samples=(seed, ctrl_samples),
                                            device=device)
    sizes, probs, num_stages = policies.padded_arrays(ctrl_jobs)
    outcomes, _ = ref_mc_outcomes(probs, num_stages, seed, ctrl_samples)
    d = sizes[np.arange(len(ctrl_jobs))[None, :], outcomes]
    succ = outcomes == num_stages[None, :] - 1
    t = np.cumsum(d[:, order], axis=1)
    cnt = succ.sum(axis=1)
    vals = np.where(cnt > 0, (t * succ[:, order]).sum(axis=1) / np.maximum(cnt, 1), 0.0)
    sigma = float(vals.std(ddof=1) / np.sqrt(ctrl_samples))
    z = abs(est - exact) / sigma
    assert z <= 3.0, f"streamed MC outside 3-sigma CLT bound: z={z}"
    control = {
        "k_combos": int(evaluator.exact_combination_count(ctrl_jobs)),
        "n_samples": ctrl_samples, "exact": float(exact),
        "streamed_est": float(est), "sigma": sigma, "z_score": float(z),
    }

    # --- throughput: K > MAX_EXACT_COMBOS, MC is the only option ---------
    n = n_jobs  # M=2 -> K = 2**27 > MAX_EXACT_COMBOS at the default
    jobs = generate_workload(rng, n)
    orders = policies.rank_order(jobs)[None]
    s_streamed = 1 << (12 if smoke else 23)
    s_materialized = 1 << (10 if smoke else 21)
    repeats = 1 if smoke else (3 if full else 2)

    def streamed_time():
        ts = []
        for rep in range(repeats + 1):  # the first rep warms up
            t0 = time.perf_counter()
            evaluator.expected_sojourn_static(jobs, orders, samples=(seed + rep, s_streamed),
                                              device=device)
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts[1:]))

    def materialized_time():
        g = np.random.default_rng(seed)
        ts = []
        for _ in range(repeats + 1):
            t0 = time.perf_counter()
            # per-call work in the materialised design: host sampling of
            # the (S, N) table, then the explicit-outcomes op
            mc_o, mc_w = evaluator.sample_outcomes(jobs, s_materialized, g)
            evaluator.expected_sojourn_static(jobs, orders, outcomes=mc_o, weights=mc_w,
                                              device=device)
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts[1:]))

    t_streamed = streamed_time()
    t_materialized = materialized_time()
    tp_streamed = s_streamed / t_streamed
    tp_materialized = s_materialized / t_materialized
    row = {
        "k_combos": 1 << n, "n_jobs": n,
        "streamed_samples": s_streamed, "streamed_s": t_streamed,
        "streamed_samples_per_s": tp_streamed,
        "materialized_samples": s_materialized, "materialized_s": t_materialized,
        "materialized_samples_per_s": tp_materialized,
        "throughput_ratio": tp_streamed / tp_materialized,
    }
    if not smoke:
        assert row["throughput_ratio"] >= 2.0, (
            f"streamed MC below the 2x throughput bar: {row}"
        )
    _save("BENCH_eval_mc", {
        "mode": "smoke" if smoke else ("full" if full else "default"),
        "device": str(resolve_device(device)),
        "clt_control": control,
        "rows": [row],
    }, out)
    return [{**row, "control_z_score": control["z_score"]}]


# ---------------------------------------------------------------------------
# Roofline aggregation (reads the dry run's cells)
# ---------------------------------------------------------------------------


def table_roofline(full: bool = False, out: str = OUT, src: str = DRYRUN):
    """The dry run's cells as the roofline table: per (arch, shape, mesh,
    serving-weight layout or not) the compute, memory and collective terms
    in ms on the modelled H100 machine, the dominant one, the compute share
    of the bound, the useful share of the executed FLOPs and the state a
    chip holds."""
    from repro_torch.launch.roofline import RooflineReport

    paths = sorted(glob.glob(os.path.join(src, "*.json")))
    if not paths:
        print(f"  (no dry-run cells in {src}; run `python -m repro_torch.launch.dryrun` first)")
        return []
    report = RooflineReport.load(paths)
    print(report.to_markdown())
    rows = [{"arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
             "tp_weights": r.get("tp_weights", False),
             "compute_ms": r["roofline"]["compute"] * 1e3,
             "memory_ms": r["roofline"]["memory"] * 1e3,
             "collective_ms": r["roofline"]["collective"] * 1e3,
             "dominant": r["roofline"]["dominant"],
             "roofline_fraction": r["roofline"]["roofline_fraction"],
             "useful_flops_ratio": r["useful_flops_ratio"],
             "state_gib_per_chip": r["state_bytes_per_chip"] / 2**30}
            for r in report.rows]
    _save("table_roofline", {"rows": rows, "cells": report.rows}, out)
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
    "eval_perf": table_eval_perf,
    "eval_dynamic": table_eval_dynamic,
    "eval_mc": table_eval_mc,
    "roofline": table_roofline,
}

#: Tables whose evaluations run on ``--device``; the rest are host code.
ON_DEVICE = ("fig1", "sojourn", "competitive", "stages", "eval_perf", "eval_dynamic",
             "eval_mc")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.study", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--table", default="all", choices=["all", *TABLES])
    ap.add_argument("--full", action="store_true", help="paper-scale trials")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sample counts and no throughput bar (eval_mc only)")
    ap.add_argument("--cache-dir", default=None, metavar="DIR",
                    help="persist the workload-keyed memo tier in DIR "
                         "(overrides REPRO_CACHE_DIR)")
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain PyTorch versions; default: the CUDA card")
    ap.add_argument("--out", default=OUT, help="directory of the JSON artifacts")
    args = ap.parse_args(argv)

    names = list(TABLES) if args.table == "all" else [args.table]
    if any(name in ON_DEVICE for name in names):
        dev = resolve_device(args.device)
        if dev.type == "cuda":
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
        if name == "eval_mc":
            kw["smoke"] = args.smoke
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
