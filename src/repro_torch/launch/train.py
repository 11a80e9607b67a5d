"""Training: the train step with micro-batch accumulation, on one device
or on a mesh, a host-side Trainer (data pipeline, checkpoint/restart,
straggler watchdog) and the ``python -m repro_torch.launch.train`` entry
point.

The counterpart of ``repro/launch/train.py``.  :class:`TrainPlan` places
the program: a device, and under a mesh the mesh and its axis rules.
``make_train_step(plan)`` gives ``(params, opt_state, batch) ->
(params, opt_state, metrics)``; the gradients come from autograd through
:func:`transformer.lm_loss` (attention through the ``flash_fwd``,
``flash_dkv`` and ``flash_dq`` kernels on the card), are summed over
``plan.accum_steps`` micro-batches in float32 and applied by
:func:`optim.adamw.apply_updates`, which updates the parameters and
moments IN PLACE (the reference donates them to get the same effect).
Nothing is compiled: PyTorch runs eagerly.

Under a mesh (``default_plan(cfg, mesh)``) the parameters, the moments
and the batch are DTensors placed by their logical axes under the plan's
rules (FSDP over the data axes, tensor parallelism over "model"; the
moments as their parameters, the batch by
:meth:`~TrainPlan.batch_shardings`); each
gradient is brought to its parameter's placements (a reduce-scatter
where it is a partial sum) before the update, which runs on each rank's
shards.  Every family runs meshed; meshed adafactor raises
``NotImplementedError``, as the reference does.  A meshed
:class:`Trainer` checkpoints and restarts as an unmeshed one: its
checkpoint holds the whole arrays, and a restart restores them onto the
plan's placements, on this mesh or another.

Command line (random weights from seed 0, SyntheticLM data; the vlm and
encdec families' image or frame embeddings drawn as the frontend stubs
draw them, :class:`StubExtras`)::

    python -m repro_torch.launch.train --smoke --device cpu    # qwen3-1.7b SMOKE
    python -m repro_torch.launch.train --steps 8 --batch 2 --seq 4096  # Qwen3-1.7B on the card
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --smoke --device cpu --mesh 4x2
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --smoke --device cpu --mesh 4x2 \
        --arch llama-3.2-vision-11b --ckpt-dir ckpt
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import frontend_shapes
from repro_torch.models.init import materialize, tree_leaves, tree_map
from repro_torch.optim import adamw as opt
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.parallel.sharding import (
    DEFAULT_RULES,
    AxisRules,
    ShardingCtx,
    check_divisible,
    is_dtensor,
    mesh_axis_sizes,
    placements,
    rules_for,
)

__all__ = ["TrainPlan", "default_plan", "make_init", "loss_and_grads", "make_train_step",
           "batch_to_device", "batch_logical", "StubExtras", "Trainer", "init_group",
           "parse_mesh", "main"]

#: The logical axes of the batch's extras, as the reference places them;
#: tokens and labels are ("batch", "seq").
EXTRA_LOGICAL = {"enc_frames": ("batch", "seq", None), "image_embeds": ("batch", None, None)}


def batch_logical(name: str) -> tuple:
    """The logical axes of the batch entry ``name``."""
    return EXTRA_LOGICAL.get(name, ("batch", "seq"))


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """Everything the launcher needs to place a training program."""

    cfg: ModelConfig
    opt_cfg: opt.OptConfig
    device: torch.device
    accum_steps: int = 1
    warmup_steps: int = 100
    total_steps: int = 10_000
    mesh: Any = None  # torch DeviceMesh, or None (one device)
    rules: AxisRules = DEFAULT_RULES

    @property
    def ctx(self) -> ShardingCtx:
        return ShardingCtx(self.mesh, self.rules)

    # -- shardings ---------------------------------------------------------

    def batch_shardings(self, batch_specs: dict):
        """The placements of each batch entry, by its name
        (:func:`batch_logical`)."""
        if self.mesh is None:
            return None
        return {k: placements(batch_logical(k), self.mesh, self.rules) for k in batch_specs}

    def place_batch(self, batch: dict) -> dict:
        """A batch whose tensors every rank holds whole, as DTensors placed
        by :meth:`batch_shardings` (each rank keeps its shard); unmeshed,
        the batch itself.  ``ValueError`` if a sharded dim does not divide
        by its mesh axes, as the reference's ``jit`` refuses it."""
        if self.mesh is None:
            return batch
        from torch.distributed.tensor import distribute_tensor

        for k, v in batch.items():
            check_divisible(f"batch[{k!r}]", v.shape, batch_logical(k), self.mesh, self.rules)
        shardings = self.batch_shardings(batch)
        return {k: distribute_tensor(v, self.mesh, shardings[k], src_data_rank=None)
                for k, v in batch.items()}


def default_plan(cfg: ModelConfig, mesh=None, *, long_context: bool = False, device=None,
                 **kw) -> TrainPlan:
    """The reference's plan: float32 moments below 2e11 parameters, bfloat16
    above; on ``mesh`` the rules of :func:`rules_for` at its model axis.
    ``device=None`` is the card, or under a mesh the mesh's device type."""
    model_axis = mesh_axis_sizes(mesh).get("model", 1) if mesh is not None else 1
    rules = rules_for(cfg, long_context=long_context, model_axis=model_axis)
    moment_dtype = "bfloat16" if cfg.param_count() > 2e11 else "float32"
    opt_cfg = kw.pop("opt_cfg", None) or opt.OptConfig(moment_dtype=moment_dtype)
    if device is None and mesh is not None:
        device = mesh.device_type
    return TrainPlan(cfg=cfg, opt_cfg=opt_cfg, device=resolve_device(device), mesh=mesh,
                     rules=rules, **kw)


def _opt_init(plan: TrainPlan, params: dict) -> opt.OptState:
    if plan.opt_cfg.kind == "adafactor":
        if plan.mesh is not None:
            raise NotImplementedError(
                "meshed adafactor shardings not wired; use adamw with "
                "moment_dtype=bfloat16 for the 1T-class configs")
        return opt.adafactor_init(params, plan.opt_cfg)
    return opt.adamw_init(params, plan.opt_cfg)


def make_init(plan: TrainPlan) -> Callable:
    """(seed) -> (params, opt_state) on the plan's device.  Under a mesh
    each parameter is drawn whole, exactly as unmeshed, and then
    distributed (each rank keeps its shard), so the meshed values equal
    the unmeshed ones."""

    def init(seed: int):
        gen = torch.Generator(device=plan.device).manual_seed(seed)
        specs = T.param_specs(plan.cfg)
        if plan.mesh is None:
            params = materialize(specs, gen, plan.device)
        else:
            ctx = plan.ctx
            params = materialize(specs, gen, plan.device,
                                 place=lambda t, spec: ctx.distribute(t, spec.logical))
        return params, _opt_init(plan, params)

    return init


def _abstract_state(plan: TrainPlan) -> tuple[dict, opt.OptState]:
    """(params, opt_state) of the plan on the ``meta`` device: the
    structure, shapes and dtypes a checkpoint restores onto, and under a
    mesh the placements (the parameters' by their logical axes, as
    :func:`make_init` places them; the moments follow)."""
    params = T.abstract_params(plan.cfg)
    if plan.mesh is not None:
        params = tree_map(plan.ctx.distribute, params, T.param_logical(plan.cfg))
    return params, _opt_init(plan, params)


def _plain(v):
    """A metric as a plain tensor (a DTensor's full value) or number."""
    if is_dtensor(v):
        return v.full_tensor().detach()
    return v.detach() if isinstance(v, torch.Tensor) else v


def loss_and_grads(params: dict, batch: dict, cfg: ModelConfig,
                   ctx: ShardingCtx = ShardingCtx.none()):
    """``(loss, metrics, grads)`` of :func:`transformer.lm_loss` at
    ``params``: the loss and metrics detached, ``grads`` a tree like
    ``params`` in each parameter's type (under a mesh, each gradient
    placed as its parameter)."""
    with torch.enable_grad():
        wrt = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = T.lm_loss(wrt, batch, cfg, ctx)
        flat = torch.autograd.grad(loss, tree_leaves(wrt))
    it = iter(flat)
    grads = tree_map(lambda _: next(it), params)
    if ctx.mesh is not None:
        grads = tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements), grads, params)
    metrics = {k: _plain(v) for k, v in metrics.items()}
    return _plain(loss), metrics, grads


def make_train_step(plan: TrainPlan) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Gradient accumulation: ``plan.accum_steps`` micro-batches (the
    batch's rows cut into that many equal parts, in order), their
    gradients summed in float32, each divided by the count, as the
    reference's ``lax.scan`` does (``train.py:134-150``); the metrics are
    averaged the same way.  The learning-rate factor is the cosine
    schedule at the step before the update.  Under a mesh the batch is
    placed by :meth:`TrainPlan.place_batch` (a batch of DTensors already
    placed passes as it is).
    """
    cfg, a, ctx = plan.cfg, plan.accum_steps, plan.ctx
    if plan.mesh is not None and plan.opt_cfg.kind == "adafactor":
        raise NotImplementedError(
            "meshed adafactor shardings not wired; use adamw with "
            "moment_dtype=bfloat16 for the 1T-class configs")

    def train_step(params, opt_state, batch):
        if plan.mesh is not None and not is_dtensor(next(iter(batch.values()))):
            batch = plan.place_batch(batch)
        if a == 1:
            _, metrics, grads = loss_and_grads(params, batch, cfg, ctx)
        else:
            grads, metrics = None, {"ce": 0.0, "aux": 0.0, "loss": 0.0}
            rows = next(iter(batch.values())).shape[0]
            if rows % a:
                raise ValueError(f"batch of {rows} rows does not split into {a} micro-batches")
            m = rows // a
            for i in range(a):
                micro = {k: v[i * m : (i + 1) * m] for k, v in batch.items()}
                if plan.mesh is not None:
                    micro = {k: v.redistribute(v.device_mesh, batch[k].placements)
                             for k, v in micro.items()}
                _, mb_metrics, g = loss_and_grads(params, micro, cfg, ctx)
                if grads is None:
                    grads = tree_map(lambda x: x.float() / a, g)
                else:
                    tree_map(lambda acc, x: acc.add_(x.float() / a), grads, g)
                del g
                metrics = {k: metrics[k] + mb_metrics[k] / a for k in metrics}
        lr_scale = cosine_schedule(opt_state.step, plan.warmup_steps, plan.total_steps)
        gnorm = _plain(opt.global_norm(grads))
        opt_state = opt.apply_updates(params, grads, opt_state, plan.opt_cfg, lr_scale)
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr_scale=lr_scale)

    return train_step


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """A host batch on ``device``: its integer arrays (tokens, labels) as
    int64 tensors, its float arrays (the extras) in their own type."""
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    return {k: v if v.is_floating_point() else v.long() for k, v in out.items()}


class StubExtras:
    """``data``'s batches with the family's extras added (``image_embeds``
    for vlm, ``enc_frames`` for encdec), drawn as the frontend stubs draw
    them (0.02 x standard normal, float32) from ``seed`` and the step: the
    command line's stand-in for the real image and speech frontends."""

    def __init__(self, data, cfg: ModelConfig, seed: int = 0):
        self.data, self.cfg, self.seed = data, cfg, seed

    def batch(self, step: int) -> dict:
        out = dict(self.data.batch(step))
        rng = np.random.default_rng((self.seed, step))
        for name, shape in frontend_shapes(self.cfg, len(out["tokens"])).items():
            out[name] = (0.02 * rng.standard_normal(shape)).astype(np.float32)
        return out


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
        is one (under a mesh, placed as the plan places a fresh init), else
        a fresh init from ``seed``."""
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


def parse_mesh(text: str) -> tuple[int, int]:
    """``"DATAxMODEL"`` (e.g. ``"4x2"``) as ``(data, model)``."""
    try:
        data, model = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DATAxMODEL, e.g. 4x2; got {text!r}") from None
    return data, model


def init_group(device: torch.device) -> None:
    """The default process group of a meshed run, unless one exists: from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ...) if it is set, else a world of one through a file store in a
    temporary directory.  NCCL on the card (each rank on its
    ``LOCAL_RANK``'s card), gloo on the CPU."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        store = os.path.join(tempfile.mkdtemp(), "store")
        dist.init_process_group(backend, init_method=f"file://{store}", rank=0, world_size=1)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description="Training run on one device or a mesh (random init)")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true", help="the arch's SMOKE config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8, help="sequences a step")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL: a meshed run over that many ranks (torchrun, or a world "
                         "of one); default: no mesh")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encdec":  # the frames track the sequence, as the reference's shapes
        cfg = dataclasses.replace(cfg, frontend_frames=args.seq)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_host_mesh

        device = resolve_device(args.device)
        init_group(device)
        mesh = make_host_mesh(*parse_mesh(args.mesh), device_type=device.type)
    plan = default_plan(cfg, mesh, device=args.device)
    data = StubExtras(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                                             global_batch=args.batch)), cfg)
    ckpt = None
    if args.ckpt_dir:
        from repro_torch.ckpt.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.ckpt_dir)
    trainer = Trainer(plan, data, ckpt)
    _, _, hist = trainer.run(args.steps, log_every=0 if dist.is_initialized() and
                             dist.get_rank() else 10)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"loss: {hist[0]:.4f} -> {hist[-1]:.4f}")
    return {"history": hist, "records": trainer.records}


if __name__ == "__main__":
    main()
