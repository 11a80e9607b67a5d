"""Production-mesh dry run: every runnable (arch x shape) cell on the
(16, 16) single-pod and (2, 16, 16) two-pod meshes, on the ``meta``
device, and the roofline inputs of each.

The counterpart of ``repro/launch/dryrun.py``.  Run it as its own
process (``python -m repro_torch.launch.dryrun ...``): it sets up torch's
``fake`` process group (a ``FakeStore`` world of 256 or 512 ranks, this
process being rank 0), which cannot share a process with a real NCCL or
gloo group.  Nothing is allocated: the parameters, optimizer moments,
batch and cache are DTensors whose local shards live on ``meta``, and
the meshed plan's own step (:func:`launch.train.make_train_step`,
:func:`launch.serve.make_prefill_fn` or ``make_decode_fn``) runs eagerly
on them under :mod:`launch.roofline`'s dispatch modes, which record rank
0's FLOPs, bytes and collective bytes.  The collectives do nothing (the
fake group), and the kernels take their plain ``meta`` routes (shapes
only), so a kernel's FLOPs are those of its plain stand-in: the SSD
scan's chunk loop (:func:`ref.ssd_chunked`) does the ``ssd_fwd``
kernel's products, the MoE oracle the ``moe_ffn_fwd`` kernel's, but the
attention stand-in (:func:`ref.ref_attention`) forms every (query, key)
score where the flash kernels skip the blocks that a causal mask or a
window hides: a causal cell's attention FLOPs are about twice the
kernels' work.

Eager execution runs every layer, so the reference's extrapolation from
two shallow compiled programs (``dryrun.py:167-190``, needed because
XLA's cost analysis counts a scanned loop's body once) is not needed:
the counts are of the whole depth.

Every cell of ``configs.shapes.runnable_cells()`` runs (33 a mesh).  A
decode cell of the vlm and encdec families also takes the static cross
memory, stacked ``(n, B, S_mem, Hkv, hd)`` K and V (``n`` the decoder
layers, or the vision model's cross periods; ``S_mem`` the frames or the
image tokens), on ``meta`` and placed as the serving plan places it, as
the reference's ``lower_cell`` builds it; like the reference's, the
state it counts is the weights and the cache.  Artifacts: one JSON a
cell under ``--out`` (default ``artifacts/dryrun_torch/``), which
``python -m repro_torch.launch.study --table roofline`` reads.

``REPRO_SERVE_TP_WEIGHTS=1`` (the reference's variable, read when
:func:`main` runs) serves the prefill and decode cells in the
serving-weight layout (``default_serve_plan(tp_weights=True)``); train
cells do not change, and each row records ``tp_weights``.  Under it the
long_500k cells fail, as the reference's do: their batch of 1 does not
divide by the ("pod", "data") axes that the layout shards it over::

    REPRO_SERVE_TP_WEIGHTS=1 python -m repro_torch.launch.dryrun --mesh both --shape decode_32k
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.shapes import SHAPES, arch_shape_config, input_specs, runnable_cells
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import MULTIPOD_SHAPE, POD_SHAPE, make_production_mesh
from repro_torch.launch.serve import default_serve_plan, make_decode_fn, make_prefill_fn
from repro_torch.launch.train import default_plan, make_train_step
from repro_torch.models import transformer as T
from repro_torch.models.init import tree_leaves, tree_map
from repro_torch.optim import adamw as opt

__all__ = ["init_fake_world", "state_bytes", "memory_shape", "analyze_cell", "main"]

OUT = os.path.join("artifacts", "dryrun_torch")
#: The reference's switch: ``REPRO_SERVE_TP_WEIGHTS=1`` serves every
#: prefill and decode cell in the serving-weight layout.
TP_WEIGHTS_ENV = "REPRO_SERVE_TP_WEIGHTS"


def init_fake_world(world: int) -> None:
    """A ``fake`` default process group of ``world`` ranks, this process
    rank 0 (an existing group is destroyed first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def state_bytes(*trees) -> int:
    """Bytes of rank 0's shards of the DTensors of ``trees``."""
    total = 0
    for tree in trees:
        for t in tree_leaves(tree):
            local = t.to_local() if hasattr(t, "to_local") else t
            total += local.numel() * local.element_size()
    return total


def memory_shape(cfg, batch: int) -> tuple[int, ...] | None:
    """The shape of each of the decode's stacked cross K and V: (n, B,
    S_mem, Hkv, hd); None for a family without a cross memory."""
    if cfg.family == "encdec":
        return cfg.n_layers, batch, cfg.frontend_frames, cfg.n_kv_heads, cfg.hd
    if cfg.family == "vlm":
        return (cfg.n_layers // cfg.cross_attn_period, batch, cfg.num_image_tokens,
                cfg.n_kv_heads, cfg.hd)
    return None


def _placed(ctx, tree, logical):
    return tree_map(lambda t, log: ctx.distribute(t, log), tree, logical)


def _program(cfg, spec, mesh, long_context: bool, specs: dict, tp_weights: bool = False):
    """(step, args, state trees) of one cell whose inputs are ``specs``
    (:func:`configs.shapes.input_specs`), every tensor on ``meta``; a
    serving cell under ``tp_weights`` takes the serving-weight layout (a
    train cell ignores it, as in the reference)."""
    params = T.abstract_params(cfg)
    logical = T.param_logical(cfg)
    if spec.kind == "train":
        plan = default_plan(cfg, mesh)
        params = _placed(plan.ctx, params, logical)
        state = opt.adamw_init(params, plan.opt_cfg)
        batch = plan.place_batch(specs)
        return make_train_step(plan), (params, state, batch), (params, state.mu, state.nu)
    plan = default_serve_plan(cfg, mesh, spec, long_context=long_context, tp_weights=tp_weights)
    params = _placed(plan.ctx, params, logical)
    if spec.kind == "prefill":
        return make_prefill_fn(plan), (params, specs), (params,)
    cache = T.init_cache(cfg, spec.global_batch, spec.seq_len, "meta", plan.cache_ctx)
    token = plan.place(specs["token"], ("batch", None), "the token")
    args = (params, token, cache, spec.seq_len - 1)
    mem = memory_shape(cfg, spec.global_batch)
    if mem is not None:
        args += (tuple(plan.place(torch.empty(mem, dtype=cfg.dtype, device="meta"),
                                  T.MEMORY_LOGICAL, "the memory") for _ in "kv"),)
    return make_decode_fn(plan), args, (params, cache)


def analyze_cell(arch: str, shape: str, multi_pod: bool, overrides: dict | None = None,
                 tp_weights: bool = False) -> dict:
    """Run one cell under the counting modes; its JSON row.  A cell whose
    batch does not divide by its mesh axes raises ``ValueError`` (under
    ``tp_weights``, every long_500k cell: the reference cannot lower them
    either)."""
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    cfg = arch_shape_config(arch, shape)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    spec = SHAPES[shape]
    t0 = time.perf_counter()
    step, args, state = _program(cfg, spec, mesh, shape == "long_500k", input_specs(arch, shape),
                                 tp_weights)
    t_setup = time.perf_counter() - t0
    flops, coll, hbm = RL.FlopCount(), RL.CollectiveBytes(), RL.HbmBytes()
    t0 = time.perf_counter()
    with flops, coll, hbm:
        step(*args)
    t_run = time.perf_counter() - t0
    n_dev = mesh.size()
    roof = RL.roofline_terms(flops.flops, hbm.bytes, coll.bytes)
    mflops = RL.model_flops(cfg, spec, spec.kind)
    return {
        "arch": arch,
        "shape": shape,
        "mesh": "pod2x16x16" if multi_pod else "pod16x16",
        "mesh_shape": list(MULTIPOD_SHAPE if multi_pod else POD_SHAPE),
        "n_devices": int(n_dev),
        "kind": spec.kind,
        "overrides": overrides or {},
        "tp_weights": tp_weights and spec.kind != "train",
        "t_setup_s": t_setup,
        "t_run_s": t_run,
        "state_bytes_per_chip": int(state_bytes(*state)),
        "flops_per_chip": float(flops.flops),
        "hbm_bytes_per_chip": float(hbm.bytes),
        "collective_bytes_per_chip": dict(coll.bytes),
        "collective_calls": dict(coll.calls),
        "model_flops_total": mflops,
        "useful_flops_ratio": mflops / (flops.flops * n_dev) if flops.flops else float("nan"),
        "param_count": cfg.param_count(),
        "param_count_active": cfg.param_count(active_only=True),
        "roofline": roof,
        "hardware": dataclasses.asdict(RL.HW),
    }


def _parse_overrides(pairs) -> dict:
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--fail-fast", action="store_true")
    ap.add_argument("--override", nargs="*", default=None, metavar="KEY=VAL",
                    help="ModelConfig overrides, e.g. remat=dots moe_group=4096")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    args = ap.parse_args(argv)
    overrides = _parse_overrides(args.override)
    tp_weights = os.environ.get(TP_WEIGHTS_ENV, "") == "1"

    cells = runnable_cells()
    if args.arch:
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape:
        cells = [c for c in cells if c[1] == args.shape]
    if not cells:
        ap.error("no runnable cell matches --arch/--shape")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    t_all = time.perf_counter()
    for multi in meshes:
        init_fake_world(512 if multi else 256)
        for arch, shape in cells:
            tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
            if args.tag:
                tag += f"__{args.tag}"
            try:
                row = analyze_cell(arch, shape, multi, overrides, tp_weights)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(row, f, indent=1)
                r = row["roofline"]
                print(f"[ok] {tag}: run {row['t_run_s']:.1f}s flops/chip "
                      f"{row['flops_per_chip']:.3e} dominant {r['dominant']} "
                      f"frac {r['roofline_fraction']:.2f} "
                      f"state {row['state_bytes_per_chip'] / 2**30:.2f} GiB/chip", flush=True)
            except Exception as e:  # noqa: BLE001 - a cell's failure is reported, then counted
                failures.append((tag, repr(e)))
                print(f"[FAIL] {tag}: {e}", flush=True)
                traceback.print_exc()
                if args.fail_fast:
                    raise
    dist.destroy_process_group()
    wall = time.perf_counter() - t_all
    if failures:
        print(f"{len(failures)} failures:")
        for tag, err in failures:
            print(" ", tag, err)
        return 1
    print(f"all {len(cells) * len(meshes)} cells ran in {wall:.1f} s")
    return 0


if __name__ == "__main__":
    torch.set_num_threads(1)
    raise SystemExit(main())
