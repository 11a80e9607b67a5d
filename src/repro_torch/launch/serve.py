"""Serving: prefill and decode step factories, greedy generation, on one
device or on a mesh, and the ``python -m repro_torch.launch.serve``
entry point.

The counterpart of ``repro/launch/serve.py`` and
``examples/serve_batch.py``.  ``make_prefill_fn(plan)`` gives
``(params, batch) -> (logits, cache)``: the prompt's float32 logits over
the padded vocabulary and the serving cache.  ``make_prime_fn(plan)``
gives ``(params, batch) -> memory``, the static cross-attention K/V that
the vlm and encdec families decode against (None for the others).
``make_decode_fn(plan)`` gives ``(params, token, cache, pos, memory=None)
-> (logits, cache)``: one new token against the cache, which it updates
IN PLACE (the reference donates the cache to get the same effect).

Under a mesh (:func:`default_serve_plan`) the weights, the batch and the
cache are DTensors, placed by their logical axes: the weights by the
plan's ``rules``, the batch's tokens and extras as the trainer places
them (:func:`~repro_torch.launch.train.batch_logical`: ``enc_frames`` by
("batch", "seq", None), ``image_embeds`` by ("batch", None, None)), the
cache by its own ``cache_rules`` (the serving cache shards its batch over
the whole mesh, or with ``sp`` its sequence over "data"), and the cross
memory by :data:`~repro_torch.models.transformer.MEMORY_LOGICAL` under
the plan's rules (under a decode shape's rules its batch over ("pod",
"model") and its sequence over "data").  A decode step attends to the
cache with the sequence-parallel
:func:`~repro_torch.models.attention.sp_decode_attention` and to the
memory through the attention kernel's DTensor route.  Every family runs
meshed.  ``default_serve_plan(..., tp_weights=True)`` is the
serving-weight layout: no weight is sharded over the data axes (so none
is gathered a token), the batch lies on ("pod", "data") and the cache
follows the same rules, its sequence over "model" (where
``sp_decode_attention`` then combines).  A batch that does not divide by
the mesh axes that shard it raises ``ValueError``, as the reference's
``jit`` refuses it.  The command line has no switch for the layout, as
the reference's has none.

Command line (random weights from ``--seed``; the real weights are not
in the repository; the vlm and encdec families' image or frame
embeddings come from the frontend stubs)::

    python -m repro_torch.launch.serve                      # qwen3-8b on the card
    python -m repro_torch.launch.serve --smoke --device cpu # its SMOKE config
    python -m repro_torch.launch.serve --arch jamba-v0.1-52b --layers 8
    torchrun --nproc-per-node 8 -m repro_torch.launch.serve --smoke --device cpu --mesh 4x2

At ``--arch qwen3-8b`` the defaults are 4 requests of 2048 prompt tokens
and 32 new tokens each (the first from the prefill, 31 decode steps).
The prefill's logits alone are B x S x 152,064 float32: 5.0 GB there.
Seamless's frame count follows ``--prompt-len``, as the reference's
shapes make it.  Jamba at its full 32 layers (51.5e9 parameters, 103 GB
in bf16) does not fit one 80 GB card: ``--layers N`` cuts the depth
(8, one period, is 26.5 GB).  ``--mesh DATAxMODEL`` needs ``torchrun``
with that many ranks, or a world of one (a 1x1 mesh).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config, get_smoke
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.launch.train import batch_logical, init_group, parse_mesh
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import make_extras
from repro_torch.models.init import materialize, tree_bytes
from repro_torch.parallel.sharding import (
    DEFAULT_RULES,
    AxisRules,
    ShardingCtx,
    check_divisible,
    is_dtensor,
    mesh_axis_sizes,
    rules_for,
    serving_weight_rules,
)

__all__ = ["ServePlan", "Generation", "default_serve_plan", "init_weights", "make_prefill_fn",
           "make_prime_fn", "make_decode_fn", "generate", "main"]

#: Bytes of one card's memory: a config whose weights alone pass it cannot
#: be served on one card.
CARD_BYTES = 80e9


@dataclasses.dataclass(frozen=True)
class ServePlan:
    cfg: ModelConfig
    max_len: int  # cache length: prompt + new tokens
    device: torch.device
    mesh: Any = None  # torch DeviceMesh, or None (one device)
    rules: AxisRules = DEFAULT_RULES
    sp: bool = False  # sequence-parallel cache (long-context decode)
    cache_rules: AxisRules | None = None  # the cache's own rules (default: rules)

    @property
    def ctx(self) -> ShardingCtx:
        return ShardingCtx(self.mesh, self.rules)

    @property
    def cache_ctx(self) -> ShardingCtx:
        return ShardingCtx(self.mesh, self.cache_rules or self.rules)

    def place(self, t: torch.Tensor, logical: tuple, name: str):
        """A tensor every rank holds whole (tokens), placed by ``logical``;
        ``ValueError`` naming it ``name`` if a sharded dim does not divide by
        its mesh axes."""
        check_divisible(name, t.shape, logical, self.mesh, self.rules)
        return self.ctx.distribute(t, logical)

    def place_batch(self, batch: dict) -> dict:
        """The batch's tensors that every rank holds whole placed by their
        names (:func:`~repro_torch.launch.train.batch_logical`); DTensors
        and an unmeshed plan's batch pass as they are."""
        if self.mesh is None:
            return batch
        return {k: v if is_dtensor(v) else self.place(v, batch_logical(k), f"batch[{k!r}]")
                for k, v in batch.items()}


def default_serve_plan(cfg: ModelConfig, mesh, shape_spec, *, long_context: bool = False,
                       tp_weights: bool = False, device=None) -> ServePlan:
    """The reference's serving plan for a shape (``configs.shapes.ShapeSpec``):
    a decode shape shards its batch over ("pod", "model") unless it is
    long-context; the cache shards its batch over the whole mesh.  With
    ``tp_weights`` the serving-weight layout
    (:func:`~repro_torch.parallel.sharding.serving_weight_rules`): weights
    tensor-parallel over "model" with their embed dim replicated, the batch
    over ("pod", "data"), and the cache follows the same rules (its
    sequence over "model").  Under a mesh the shape's batch must divide by
    the axes that shard it under both rule tables, else ``ValueError``, as
    the reference's ``jit`` refuses it (a long-context batch of 1 under
    ``tp_weights``, say).  ``device=None`` is the card, or under a mesh the
    mesh's device type."""
    model_axis = mesh_axis_sizes(mesh).get("model", 1) if mesh is not None else 1
    decode = shape_spec.kind == "decode" and not long_context
    rules = rules_for(cfg, long_context=long_context, decode_batch=decode, model_axis=model_axis)
    if tp_weights:
        rules = serving_weight_rules(rules)
        cache_rules = rules
    else:
        cache_rules = rules_for(cfg, long_context=long_context, decode_batch=True,
                                model_axis=model_axis)
    if mesh is not None:
        for r in (rules, cache_rules):
            check_divisible("the batch", (shape_spec.global_batch,), ("batch",), mesh, r)
    if device is None and mesh is not None:
        device = mesh.device_type
    return ServePlan(cfg=cfg, max_len=shape_spec.seq_len, device=resolve_device(device),
                     mesh=mesh, rules=rules, sp=long_context,
                     cache_rules=cache_rules)


def init_weights(plan: ServePlan, generator: torch.Generator) -> dict:
    """Random weights from ``generator`` on the plan's device; under a mesh
    each leaf is drawn whole, as unmeshed, and each rank keeps its shard,
    so the meshed weights equal the unmeshed ones."""
    specs = T.param_specs(plan.cfg)
    if plan.mesh is None:
        return materialize(specs, generator, plan.device)
    ctx = plan.ctx
    return materialize(specs, generator, plan.device,
                       place=lambda t, spec: ctx.distribute(t, spec.logical))


def _no_grad(plan: ServePlan):
    """``inference_mode`` on one device; ``no_grad`` under a mesh (DTensor's
    view ops cannot make inference tensors)."""
    return torch.no_grad() if plan.mesh is not None else torch.inference_mode()


def make_prefill_fn(plan: ServePlan) -> Callable:
    cfg = plan.cfg

    @_no_grad(plan)
    def prefill_step(params, batch):
        return T.prefill(params, plan.place_batch(batch), cfg, max_len=plan.max_len,
                         ctx=plan.ctx, cache_ctx=plan.cache_ctx)

    return prefill_step


def make_prime_fn(plan: ServePlan) -> Callable:
    cfg = plan.cfg

    @_no_grad(plan)
    def prime(params, batch):
        return T.prime_memory(params, cfg, plan.place_batch(batch), ctx=plan.ctx)

    return prime


def make_decode_fn(plan: ServePlan) -> Callable:
    cfg = plan.cfg

    @_no_grad(plan)
    def decode(params, token, cache, pos: int, memory=None):
        if plan.mesh is not None and not is_dtensor(token):
            token = plan.place(token, ("batch", None), "the token")
        if plan.mesh is not None and memory is not None:
            memory = tuple(plan.ctx.constrain(m, T.MEMORY_LOGICAL) if is_dtensor(m) else
                           plan.place(m, T.MEMORY_LOGICAL, "the memory") for m in memory)
        return T.decode_step(params, token, cache, pos, cfg, memory, ctx=plan.ctx, sp=plan.sp)

    return decode


@dataclasses.dataclass
class Generation:
    tokens: torch.Tensor  # (B, gen_len) greedy tokens, the first from the prefill
    first_decode_logits: torch.Tensor | None  # (B, V) float32 of decode step 1
    prefill_s: float  # wall seconds of the prefill (and prime_memory), device work included
    decode_s: list  # wall seconds of each decode step
    cache_bytes: int  # of the whole cache (every rank's shards, under a mesh)
    logits_bytes: int  # of the prefill's logits


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _full(t: torch.Tensor) -> torch.Tensor:
    """A plain tensor: a DTensor's whole value, gathered."""
    return t.full_tensor() if is_dtensor(t) else t


def generate(plan: ServePlan, params: dict, prompts: torch.Tensor, gen_len: int,
             extras: dict | None = None) -> Generation:
    """Prefill ``prompts`` (B, S) with the batch's ``extras``
    (``image_embeds`` for vlm, ``enc_frames`` for encdec) and decode
    greedily: ``gen_len`` new tokens per request, the first from the
    prefill's last logits and the rest from ``gen_len - 1`` decode steps.
    For vlm and encdec the cross memory is primed once after the prefill,
    inside its timed wall (it is part of the time to the first token), and
    every decode step attends to it.  Times are host wall clock around
    work that ends in a device synchronisation.  Under a mesh every rank
    gets the same tokens and logits (the last position's logits are
    gathered before the argmax)."""
    cfg, dev = plan.cfg, plan.device
    b, s = prompts.shape
    if s + gen_len > plan.max_len:
        raise ValueError(f"prompt {s} + {gen_len} new tokens exceed max_len {plan.max_len}")
    prefill, decode = make_prefill_fn(plan), make_decode_fn(plan)
    batch = {"tokens": prompts, **(extras or {})}
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    memory = make_prime_fn(plan)(params, batch)
    tok = _full(logits[:, -1])[:, : cfg.vocab_size].argmax(dim=-1, keepdim=True)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    logits_bytes = logits.numel() * logits.element_size()
    del logits
    out, decode_s, first = [tok], [], None
    for pos in range(s, s + gen_len - 1):
        t0 = time.perf_counter()
        lg, cache = decode(params, tok, cache, pos, memory)
        lg = _full(lg[:, 0])
        tok = lg[:, : cfg.vocab_size].argmax(dim=-1, keepdim=True)
        _sync(dev)
        decode_s.append(time.perf_counter() - t0)
        if first is None:
            first = lg.clone()
        out.append(tok)
    return Generation(torch.cat(out, dim=1), first, prefill_s, decode_s,
                      tree_bytes(cache), logits_bytes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced SMOKE config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers at full width (get_config(arch, n_layers=N))")
    ap.add_argument("--device", default=None, help="default: the CUDA card; 'cpu' for plain torch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=None, help="default 2048 (16 with --smoke)")
    ap.add_argument("--gen-len", type=int, default=None, help="new tokens; default 32 (8 with --smoke)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL: serve meshed over that many ranks (torchrun, or a world "
                         "of one); default: no mesh")
    args = ap.parse_args(argv)

    depth = {"n_layers": args.layers} if args.layers else {}
    cfg = get_smoke(args.arch, **depth) if args.smoke else get_config(args.arch, **depth)
    prompt_len = args.prompt_len or (16 if args.smoke else 2048)
    gen_len = args.gen_len or (8 if args.smoke else 32)
    if cfg.family == "encdec":  # the frames track the prompt, as the reference's shapes
        cfg = dataclasses.replace(cfg, frontend_frames=prompt_len)
    weight_bytes = cfg.param_count() * cfg.pdtype.itemsize
    if not args.smoke and weight_bytes > CARD_BYTES:
        ap.error(f"{cfg.name} at {cfg.n_layers} layers has {cfg.param_count() / 1e9:.4g} B "
                 f"parameters ({weight_bytes / 1e9:.4g} GB), more than one card holds: cut the "
                 "depth with --layers")
    dev = resolve_device(args.device)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_host_mesh

        init_group(dev)
        mesh = make_host_mesh(*parse_mesh(args.mesh), device_type=dev.type)
        dev = resolve_device(dev.type)  # this rank's card
    shape = ShapeSpec("cli", prompt_len + gen_len, args.batch, "prefill")
    plan = (ServePlan(cfg=cfg, max_len=shape.seq_len, device=dev) if mesh is None else
            default_serve_plan(cfg, mesh, shape))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_weights(plan, gen)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, prompt_len), generator=gen,
                            device=dev)
    extras = make_extras(gen, cfg, args.batch)
    res = generate(plan, params, prompts, gen_len, extras)
    if mesh is not None and dist.get_rank():
        return 0

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    steps = len(res.decode_s)
    print(f"model {cfg.name} on {name}: batch={args.batch} prompt={prompt_len} new={gen_len}")
    print(f"weights {tree_bytes(params) / 1e9:.4g} GB, cache {res.cache_bytes / 1e9:.4g} GB, "
          f"prefill logits {res.logits_bytes / 1e9:.4g} GB")
    print(f"prefill: {res.prefill_s * 1e3:.1f} ms   decode: "
          f"{sum(res.decode_s) / max(steps, 1) * 1e3:.2f} ms/token over {steps} steps")
    for i in range(args.batch):
        print(f"  req{i}: {res.tokens[i, :12].tolist()} ...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
