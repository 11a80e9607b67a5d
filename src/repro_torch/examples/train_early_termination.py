"""End-to-end driver: train a real model with checkpoint-based early
termination — the paper's job model running on the actual data plane.

The counterpart of ``examples/train_early_termination.py`` on the port.
A *stage* is ``--steps-per-stage`` optimizer steps; at each stage
boundary a metric gate checks training-loss improvement and terminates
unpromising jobs early (the paper's early termination), checkpointing
either way (fault tolerance).

``--preset tiny`` (the default) is Qwen3-1.7B's SMOKE config (head dim
32), on the card as on the CPU.  ``--preset 100m`` trains a ~100M-parameter Qwen3-style model (Qwen3-1.7B's
head dim, 128).  Run::

    python -m repro_torch.examples.train_early_termination --device cpu
    python -m repro_torch.examples.train_early_termination --preset 100m --stages 3
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

import numpy as np

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.train import Trainer, default_plan

__all__ = ["make_cfg", "main"]


def make_cfg(preset: str):
    """The preset's config, the same on every device."""
    if preset == "tiny":
        return get_smoke("qwen3-1.7b")
    if preset == "100m":
        # ~100M params: qwen3 geometry scaled down
        return dataclasses.replace(
            get_config("qwen3-1.7b"),
            n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
            vocab_size=32768, remat="none",
        )
    raise ValueError(preset)


def main(argv: list[str] | None = None) -> list[float]:
    """Run the job; returns its per-stage losses."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"],
                    help="tiny: Qwen3-1.7B SMOKE (head dim 32); "
                         "100m: a ~100M-parameter Qwen3 (head dim 128)")
    ap.add_argument("--stages", type=int, default=3)
    ap.add_argument("--steps-per-stage", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--min-improvement", type=float, default=0.005,
                    help="terminate early if per-stage loss drop is below this")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for plain torch")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = make_cfg(args.preset)
    n_params = cfg.param_count()
    print(f"model: {cfg.name}  params={n_params/1e6:.1f}M  "
          f"stages={args.stages} x {args.steps_per_stage} steps")

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                  global_batch=args.batch))
    with tempfile.TemporaryDirectory() as ckpt_dir:
        ckpt = CheckpointManager(ckpt_dir, keep=2)
        plan = default_plan(cfg, device=device)
        trainer = Trainer(plan, data, ckpt, ckpt_every=args.steps_per_stage)

        stage_losses = []
        for stage in range(args.stages):
            _, _, hist = trainer.run(args.steps_per_stage, log_every=10)
            stage_losses.append(float(np.mean(hist[-5:])))
            print(f"[stage {stage}] loss={stage_losses[-1]:.4f} "
                  f"(ckpt at step {ckpt.latest_step()})")
            if len(stage_losses) >= 2:
                improvement = stage_losses[-2] - stage_losses[-1]
                if improvement < args.min_improvement:
                    print(f"[stage {stage}] EARLY TERMINATION: "
                          f"improvement {improvement:.4f} < {args.min_improvement}")
                    break
        else:
            print("job SUCCESSFUL: completed all stages")
        print(f"loss trajectory per stage: {np.round(stage_losses, 4)}")
    return stage_losses


if __name__ == "__main__":
    main()
