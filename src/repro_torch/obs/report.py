"""``python -m repro_torch.obs.report`` — replay, trace, measure, export.

Replays a synthetic Philly-trace workload (``repro_torch.core.trace``)
through the cluster manager with a :class:`~repro_torch.obs.TraceRecorder`
and a :class:`~repro_torch.obs.MetricsRegistry` attached, then:

* writes ``trace.json`` — Chrome trace-event JSON; open it at
  https://ui.perfetto.dev (or ``chrome://tracing``) for per-server
  Gantt tracks plus queue-depth / server-occupancy counters;
* writes ``metrics.json`` — the metrics snapshot (sojourn percentiles,
  busy fraction, wasted work, restart counts), the workload-cache
  stats, profiling spans (with ``--profile``), and the trace summary;
* prints a text report.

``--validate`` checks the exported trace against the schema (CI runs
this).  ``--bench-overhead`` replays the same workload with tracing
off vs on, asserts the sojourn results agree to 1e-9, and reports the
batched observer dispatch overhead (acceptance bar: <= 10% on a
>= 100k-event replay — use ``--jobs 20000`` or more to get there).

The port's counterpart of ``python -m repro.obs.report``, with the same
options.  Its default ``--out`` is ``artifacts/obs_torch``, beside the
reference's ``artifacts/obs``, which it never writes.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from repro_torch.cluster.faults import FaultConfig
from repro_torch.cluster.manager import ClusterManager, TrainingJob
from repro_torch.core import policies, trace
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import profiling
from repro_torch.obs.recorder import TraceRecorder, validate_chrome_trace

__all__ = ["main", "replay", "bench_overhead"]


def _make_jobs(args) -> list:
    """Load-matched synthetic Philly trace (same scaling as benchmarks)."""
    from repro_torch.configs.paper_workloads import TRACE

    duration = args.duration_days
    if duration is None:
        duration = TRACE.duration_days * (args.jobs / TRACE.n_jobs)
    rng = np.random.default_rng(args.seed)
    return trace.synthesize_trace(rng, n_jobs=args.jobs, duration_days=duration)


def _manager(specs, args, fresh_seed: int = 0) -> ClusterManager:
    fault_cfg = None
    if args.faults:
        # MTBF sized so the per-job abort interval stays well above the
        # Philly-scale stage durations (hours): jobs retry a handful of
        # times, they don't thrash.
        fault_cfg = FaultConfig(
            mtbf_hours=500.0, restart_overhead=60.0,
            straggler_prob=0.05, straggler_slowdown=4.0,
        )
    return ClusterManager(
        [TrainingJob(spec=s) for s in specs],
        args.servers,
        policy=args.policy,
        fault_cfg=fault_cfg,
        nodes_per_server=4 if args.faults else 1,
        rng=np.random.default_rng(args.seed + fresh_seed),
        resize_events=args.resize,
    )


def replay(specs, args, recorder=None, registry=None):
    """One cluster-manager replay; returns its :class:`ClusterResult`."""
    return _manager(specs, args).run(recorder=recorder, metrics=registry)


def bench_overhead(specs, args, repeats: int = 3) -> dict:
    """Traced-vs-untraced wall clock + bit-level result agreement."""

    def timed(traced: bool):
        times, results, n_events = [], [], 0
        for _ in range(repeats):
            rec = TraceRecorder() if traced else None
            t0 = time.perf_counter()
            res = replay(specs, args, recorder=rec)
            times.append(time.perf_counter() - t0)
            results.append(res.mean_sojourn_successful)
            if rec is not None:
                n_events = len(rec)
                rec.clear()
        return float(np.median(times)), results, n_events

    t_off, r_off, _ = timed(traced=False)
    t_on, r_on, n_events = timed(traced=True)
    # identical seeds => identical runs; tracing must not perturb them
    err = max(
        abs(a - b) / max(abs(b), 1e-300) for a, b in zip(r_on, r_off)
    )
    assert err <= 1e-9, f"tracing perturbed sojourn results: relerr={err}"
    return {
        "events": n_events,
        "repeats": repeats,
        "untraced_s": t_off,
        "traced_s": t_on,
        "overhead_pct": 100.0 * (t_on / t_off - 1.0) if t_off > 0 else 0.0,
        "max_relerr": err,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--jobs", type=int, default=300)
    ap.add_argument("--servers", type=int, default=8)
    ap.add_argument("--policy", default="rank",
                    choices=["rank", "serpt", "sr", "fifo"])
    ap.add_argument("--duration-days", type=float, default=None,
                    help="trace span (default: load-matched to the paper trace)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--faults", action="store_true",
                    help="inject node failures + stragglers")
    ap.add_argument("--resize", type=float, nargs=2, action="append",
                    metavar=("T", "TARGET"), default=None,
                    help="elastic resize event (repeatable)")
    ap.add_argument("--batch-size", type=int, default=4096,
                    help="observer dispatch batch")
    ap.add_argument("--out", default=os.path.join("artifacts", "obs_torch"))
    ap.add_argument("--validate", action="store_true",
                    help="validate the exported trace JSON against the schema")
    ap.add_argument("--bench-overhead", action="store_true",
                    help="measure traced-vs-untraced wall-clock overhead")
    ap.add_argument("--profile", action="store_true",
                    help="enable kernel/cache profiling spans")
    args = ap.parse_args(argv)
    args.resize = [(t, int(w)) for t, w in args.resize] if args.resize else None

    if args.profile:
        profiling.enable()
    os.makedirs(args.out, exist_ok=True)
    specs = _make_jobs(args)

    recorder = TraceRecorder(batch_size=args.batch_size)
    registry = obs_metrics.MetricsRegistry()
    t0 = time.perf_counter()
    res = replay(specs, args, recorder=recorder, registry=registry)
    wall = time.perf_counter() - t0

    trace_path = os.path.join(args.out, "trace.json")
    trace_obj = recorder.write_chrome_trace(trace_path)
    summary = {
        "jobs": args.jobs, "servers": args.servers, "policy": args.policy,
        "faults": bool(args.faults), "records": len(recorder),
        "counts": recorder.counts(), "wall_s": wall,
    }
    if args.validate:
        summary["trace_schema"] = validate_chrome_trace(trace_obj)
        print(f"trace schema OK: {summary['trace_schema']}")
    if args.bench_overhead:
        summary["overhead"] = bench_overhead(specs, args)

    # fold profiling spans (default registry) into the run registry dump
    extra = {
        "run": summary,
        "workload_cache": policies.cache_stats(),
    }
    if args.profile:
        extra["profiling"] = obs_metrics.get_registry().snapshot()
    metrics_path = os.path.join(args.out, "metrics.json")
    registry.to_json(metrics_path, **extra)

    qd = recorder.queue_depth_series()
    print(f"replayed {args.jobs} jobs / {args.servers} servers "
          f"({args.policy}) in {wall:.2f}s -> {len(recorder)} trace records")
    print(f"  success {res.n_success}/{res.n_jobs}  "
          f"makespan {res.makespan:.3f}  restarts {res.restarts}")
    if qd.size:
        print(f"  queue depth: peak {int(qd[:, 1].max())}  "
              f"mean {qd[:, 1].mean():.2f}")
    print(obs_metrics.format_snapshot(registry.snapshot(), title="run metrics"))
    if args.profile:
        print(obs_metrics.format_snapshot(
            obs_metrics.get_registry().snapshot(), title="profiling"))
    if args.bench_overhead:
        ov = summary["overhead"]
        print(f"== overhead ==\n  {ov['events']} events: untraced "
              f"{ov['untraced_s']:.3f}s traced {ov['traced_s']:.3f}s "
              f"-> +{ov['overhead_pct']:.2f}% (max relerr {ov['max_relerr']:.2e})")
    print(f"wrote {trace_path} (load at https://ui.perfetto.dev) and "
          f"{metrics_path}")
    print(json.dumps(summary["counts"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
