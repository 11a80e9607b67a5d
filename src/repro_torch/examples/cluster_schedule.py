"""End-to-end cluster demo: the paper's RANK policy gang-scheduling REAL
training jobs (tiny models, real train steps) with early termination,
node failures and elastic scaling.

The counterpart of ``examples/cluster_schedule.py`` on the port: the
same pool, hazards, sizes, random draws and printout, on
:class:`repro_torch.cluster.manager.ClusterManager` and the port's
:class:`~repro_torch.launch.train.Trainer`.  Each job is a reduced-config
architecture from the pool (its SMOKE config, on the card as on the
CPU); a stage runs actual
optimizer steps, and the metric gate terminates jobs whose loss stops
improving — so the scheduler's size distributions come from the jobs'
stage history, and sojourn times are real wall-clock seconds.  Run::

    python -m repro_torch.examples.cluster_schedule --jobs 6 --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.cluster.faults import FaultConfig
from repro_torch.cluster.manager import ClusterManager, TrainingJob
from repro_torch.configs.registry import get_smoke
from repro_torch.core import policies
from repro_torch.core.jobs import JobSpec
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.train import Trainer, default_plan
from repro_torch.obs import MetricsRegistry, TraceRecorder, format_snapshot

__all__ = ["ARCH_POOL", "make_real_runner", "main"]

ARCH_POOL = ["qwen3-1.7b", "mamba2-1.3b", "mixtral-8x22b", "granite-3-8b",
             "llama3-8b", "jamba-v0.1-52b"]


def make_real_runner(arch: str, steps_per_stage: int, min_improvement: float, device=None):
    """A stage = real train steps on ``device``; gate on loss improvement."""
    device = resolve_device(device)
    cfg = get_smoke(arch)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=4))
    trainer = Trainer(default_plan(cfg, device=device), data, None)
    state = {"last": np.inf}

    def runner(job: TrainingJob, stage: int):
        t0 = time.perf_counter()
        _, _, hist = trainer.run(steps_per_stage, log_every=0)
        wall = time.perf_counter() - t0
        loss = float(np.mean(hist[-3:]))
        improved = state["last"] - loss
        state["last"] = loss
        terminated = stage > 0 and improved < min_improvement
        return wall, terminated

    return runner


def main(argv: list[str] | None = None):
    """Run the cluster; returns ``(ClusterResult, jobs)``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--servers", type=int, default=2)
    ap.add_argument("--steps-per-stage", type=int, default=5)
    ap.add_argument("--stages", type=int, default=3)
    ap.add_argument("--policy", default="rank", choices=["rank", "serpt", "sr", "fifo"])
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto-loadable Chrome trace JSON here")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for plain torch")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # index/duration tables for repeated runs persist across invocations
    policies.ensure_cache_dir()

    rng = np.random.default_rng(0)
    jobs = []
    for i in range(args.jobs):
        arch = ARCH_POOL[i % len(ARCH_POOL)]
        # size distribution from "historical stats": per-stage hazard ~ U(0.2, 0.5)
        hazards = rng.uniform(0.2, 0.5, args.stages - 1)
        probs, surv = [], 1.0
        for h in hazards:
            probs.append(surv * h)
            surv *= 1 - h
        probs.append(surv)
        sizes = np.cumsum(rng.uniform(2.0, 6.0, args.stages))
        spec = JobSpec(sizes=sizes, probs=np.array(probs), arrival=float(i) * 0.5,
                       job_id=i)
        jobs.append(TrainingJob(
            spec=spec, steps_per_stage=args.steps_per_stage,
            runner=make_real_runner(arch, args.steps_per_stage, 0.002, device),
            name=f"{arch}#{i}",
        ))

    print(f"scheduling {args.jobs} REAL training jobs on {args.servers} servers "
          f"({args.policy} policy)")
    cm = ClusterManager(
        jobs, args.servers, policy=args.policy, rng=rng,
        fault_cfg=FaultConfig(mtbf_hours=1e6),  # demo: no injected failures
    )
    metrics = MetricsRegistry()
    recorder = TraceRecorder()
    res = cm.run(recorder=recorder, metrics=metrics)
    print()
    print(format_snapshot(metrics.snapshot(), title=f"run metrics ({res.policy})"))
    for j in jobs:
        status = "SUCCESS" if j.success else f"terminated@stage{j.stage - 1}"
        print(f"  {j.name:22s} {status}")
    if args.trace_out:
        recorder.write_chrome_trace(args.trace_out)
        print(f"\nwrote {len(recorder)} trace records -> {args.trace_out} "
              "(load in https://ui.perfetto.dev)")
    return res, jobs


if __name__ == "__main__":
    main()
