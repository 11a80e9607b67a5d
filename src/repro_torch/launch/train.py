"""Training on one device: the train step with micro-batch accumulation,
a host-side Trainer (data pipeline, checkpoint/restart, straggler
watchdog) and the ``python -m repro_torch.launch.train`` entry point.

The counterpart of ``repro/launch/train.py`` without a mesh (sharding is
ROADMAP slice 8): :class:`TrainPlan` names the device where the
reference names a mesh and its axis rules.  ``make_train_step(plan)``
gives ``(params, opt_state, batch) -> (params, opt_state, metrics)``;
the gradients come from autograd through :func:`transformer.lm_loss`
(attention through the ``flash_fwd``, ``flash_dkv`` and ``flash_dq``
kernels on the card), are summed over ``plan.accum_steps`` micro-batches
in float32 and applied by :func:`optim.adamw.apply_updates`, which
updates the parameters and moments IN PLACE (the reference donates them
to get the same effect).  Nothing is compiled: PyTorch runs eagerly.

Command line (random weights from seed 0, SyntheticLM data)::

    python -m repro_torch.launch.train --smoke --device cpu    # qwen3-1.7b SMOKE
    python -m repro_torch.launch.train --steps 8 --batch 2 --seq 4096  # Qwen3-1.7B on the card
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import torch

from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import tree_leaves, tree_map
from repro_torch.optim import adamw as opt
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["TrainPlan", "default_plan", "make_init", "loss_and_grads", "make_train_step",
           "batch_to_device", "Trainer", "main"]


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """Everything the launcher needs to place a training program."""

    cfg: ModelConfig
    opt_cfg: opt.OptConfig
    device: torch.device
    accum_steps: int = 1
    warmup_steps: int = 100
    total_steps: int = 10_000


def default_plan(cfg: ModelConfig, device=None, **kw) -> TrainPlan:
    """The reference's plan on one device (``device=None`` is the card):
    float32 moments below 2e11 parameters, bfloat16 above."""
    moment_dtype = "bfloat16" if cfg.param_count() > 2e11 else "float32"
    opt_cfg = kw.pop("opt_cfg", None) or opt.OptConfig(moment_dtype=moment_dtype)
    return TrainPlan(cfg=cfg, opt_cfg=opt_cfg, device=resolve_device(device), **kw)


def _opt_init(plan: TrainPlan, params: dict) -> opt.OptState:
    if plan.opt_cfg.kind == "adafactor":
        return opt.adafactor_init(params, plan.opt_cfg)
    return opt.adamw_init(params, plan.opt_cfg)


def make_init(plan: TrainPlan) -> Callable:
    """(seed) -> (params, opt_state) on the plan's device."""

    def init(seed: int):
        gen = torch.Generator(device=plan.device).manual_seed(seed)
        params = T.init_params(plan.cfg, gen, plan.device)
        return params, _opt_init(plan, params)

    return init


def _abstract_state(plan: TrainPlan) -> tuple[dict, opt.OptState]:
    """(params, opt_state) of the plan on the ``meta`` device: the
    structure, shapes and dtypes a checkpoint restores onto."""
    params = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                      T.param_specs(plan.cfg))
    return params, _opt_init(plan, params)


def loss_and_grads(params: dict, batch: dict, cfg: ModelConfig):
    """``(loss, metrics, grads)`` of :func:`transformer.lm_loss` at
    ``params``: the loss and metrics detached, ``grads`` a tree like
    ``params`` in each parameter's type."""
    with torch.enable_grad():
        wrt = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = T.lm_loss(wrt, batch, cfg)
        flat = torch.autograd.grad(loss, tree_leaves(wrt))
    it = iter(flat)
    grads = tree_map(lambda _: next(it), params)
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def make_train_step(plan: TrainPlan) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Gradient accumulation: ``plan.accum_steps`` micro-batches (the
    batch's rows cut into that many equal parts, in order), their
    gradients summed in float32, each divided by the count, as the
    reference's ``lax.scan`` does (``train.py:134-150``); the metrics are
    averaged the same way.  The learning-rate factor is the cosine
    schedule at the step before the update.
    """
    cfg, a = plan.cfg, plan.accum_steps

    def train_step(params, opt_state, batch):
        if a == 1:
            _, metrics, grads = loss_and_grads(params, batch, cfg)
        else:
            grads, metrics = None, {"ce": 0.0, "aux": 0.0, "loss": 0.0}
            rows = next(iter(batch.values())).shape[0]
            if rows % a:
                raise ValueError(f"batch of {rows} rows does not split into {a} micro-batches")
            m = rows // a
            for i in range(a):
                micro = {k: v[i * m : (i + 1) * m] for k, v in batch.items()}
                _, mb_metrics, g = loss_and_grads(params, micro, cfg)
                if grads is None:
                    grads = tree_map(lambda x: x.float() / a, g)
                else:
                    tree_map(lambda acc, x: acc.add_(x.float() / a), grads, g)
                del g
                metrics = {k: metrics[k] + mb_metrics[k] / a for k in metrics}
        lr_scale = cosine_schedule(opt_state.step, plan.warmup_steps, plan.total_steps)
        gnorm = opt.global_norm(grads)
        opt_state = opt.apply_updates(params, grads, opt_state, plan.opt_cfg, lr_scale)
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr_scale=lr_scale)

    return train_step


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """A host batch of int32 arrays as int64 tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device).long() for k, v in batch.items()}


class Trainer:
    """Training loop with checkpoint/restart and a step-time watchdog.

    The watchdog is the reference's single-job straggler mitigation: a
    step slower than ``straggler_factor`` x the moving average of step
    times counts as a straggler event (not folded into the average).
    ``records`` keeps each step's loss, gradient norm, learning-rate
    factor and wall seconds (host clock, ending when the loss has reached
    the host, so the device's work is inside it)."""

    def __init__(
        self,
        plan: TrainPlan,
        data,
        ckpt_manager=None,
        ckpt_every: int = 100,
        straggler_factor: float = 3.0,
    ):
        self.plan = plan
        self.data = data
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.step_fn = make_train_step(plan)
        self._ewma = None
        self.straggler_events = 0
        self.records: list[dict] = []

    def restore_or_init(self, seed: int = 0):
        """(params, opt_state, first step): the latest checkpoint if there
        is one, else a fresh init from ``seed``."""
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            step = self.ckpt.latest_step()
            params, state = _abstract_state(self.plan)
            tree = self.ckpt.restore(step, {"params": params, "opt": state},
                                     device=self.plan.device)
            return tree["params"], tree["opt"], step
        params, state = make_init(self.plan)(seed)
        return params, state, 0

    def run(self, steps: int, seed: int = 0, log_every: int = 10, log=print):
        params, state, start = self.restore_or_init(seed)
        history = []
        for step in range(start, start + steps):
            batch = batch_to_device(self.data.batch(step), self.plan.device)
            t0 = time.perf_counter()
            params, state, metrics = self.step_fn(params, state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if self._ewma is None:
                self._ewma = dt
            elif dt > self.straggler_factor * self._ewma and step > start + 2:
                self.straggler_events += 1
            else:
                self._ewma = 0.9 * self._ewma + 0.1 * dt
            history.append(loss)
            self.records.append({"step": step, "loss": loss,
                                 "grad_norm": float(metrics["grad_norm"]),
                                 "lr_scale": metrics["lr_scale"], "seconds": dt})
            if log_every and step % log_every == 0:
                log(f"step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if self.ckpt is not None and (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, {"params": params, "opt": state})
        if self.ckpt is not None:
            self.ckpt.save(start + steps, {"params": params, "opt": state}, blocking=True)
        return params, state, history


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description="Training run on one device (random init)")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true", help="the arch's SMOKE config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8, help="sequences a step")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    plan = default_plan(cfg, args.device)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                  global_batch=args.batch))
    ckpt = None
    if args.ckpt_dir:
        from repro_torch.ckpt.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.ckpt_dir)
    trainer = Trainer(plan, data, ckpt)
    _, _, hist = trainer.run(args.steps)
    print(f"loss: {hist[0]:.4f} -> {hist[-1]:.4f}")
    return {"history": hist, "records": trainer.records}


if __name__ == "__main__":
    main()
