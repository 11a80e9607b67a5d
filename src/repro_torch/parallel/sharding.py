"""Logical-axis partitioning on a torch ``DeviceMesh``.

The counterpart of ``repro/parallel/sharding.py``.  Every parameter and
activation of :mod:`repro_torch.models` carries a tuple of *logical*
axis names (``ParamSpec.logical``, the cache tuples of
:func:`repro_torch.models.transformer.cache_logical`, the ``constrain``
calls of the model code).  :class:`AxisRules` maps logical names to mesh
axes; :func:`placements` turns the result into DTensor placements, one a
mesh dim.  The same model code then runs unmeshed (plain tensors, the
context :meth:`ShardingCtx.none`), on a one-card (1, 1) mesh, on a gloo
mesh of CPU ranks, or on the (16, 16) ``("data", "model")`` and
(2, 16, 16) ``("pod", "data", "model")`` production meshes of
:mod:`repro_torch.launch.mesh`.

Sharding strategy (the reference's):

* tensor-parallel dims (heads, ffn, vocab, experts) -> ``"model"``;
* FSDP: the ``"embed"`` dim of weight matrices -> ``("pod", "data")``, so
  parameters and optimizer moments are fully sharded (ZeRO-3);
* batch -> ``("pod", "data")``; sequence (long context) -> ``"data"``.

Rules drop mesh axes that are absent from the mesh, so one rule table
serves both production meshes.  :meth:`AxisRules.resolve` returns a
plain tuple a dim (None, an axis name, or a tuple of names) where the
reference returns a ``PartitionSpec``; a dim sharded over
``("pod", "data")`` gets ``Shard(d)`` on both mesh dims, pod-major as
in GSPMD (DTensor splits a dim over its mesh dims in mesh order).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch
from torch.distributed.tensor import DTensor

__all__ = [
    "AxisRules",
    "DEFAULT_RULES",
    "LONG_CONTEXT_RULES",
    "ShardingCtx",
    "all_reduce",
    "contiguous_grads",
    "assign",
    "check_divisible",
    "is_dtensor",
    "local_call",
    "local_offsets",
    "local_zeros",
    "mesh_axis_sizes",
    "placements",
    "replicate_like",
    "replicated_sum",
    "rules_for",
    "serving_weight_rules",
    "shard_pytree_spec",
    "shard_start",
]

MeshAxes = tuple[str, ...]


def _axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names: a DeviceMesh's ``mesh_dim_names``, or the
    ``axis_names`` of any stand-in that has them (a fake mesh in tests)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping logical axis name -> mesh axis (or tuple of mesh axes)."""

    rules: Mapping[str, str | MeshAxes | None]

    def resolve(self, logical: Sequence[str | None], mesh) -> tuple:
        """The mesh axes of each dim of a logical shape on ``mesh``: None,
        an axis name, or a tuple of names.

        Mesh axes absent from ``mesh`` are dropped; a mesh axis goes to the
        first dim that asks for it (later dims replicate), as GSPMD
        requires; trailing Nones are trimmed.
        """
        names = _axis_names(mesh)
        used: set[str] = set()
        out: list[Any] = []
        for name in logical:
            spec = self.rules.get(name) if name is not None else None
            if spec is None:
                out.append(None)
                continue
            axes = (spec,) if isinstance(spec, str) else tuple(spec)
            axes = tuple(a for a in axes if a in names and a not in used)
            used.update(axes)
            if not axes:
                out.append(None)
            elif len(axes) == 1:
                out.append(axes[0])
            else:
                out.append(axes)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def replace(self, **updates: str | MeshAxes | None) -> "AxisRules":
        merged = dict(self.rules)
        merged.update(updates)
        return AxisRules(merged)


#: Baseline rules: FSDP over (pod, data) + TP over model.
DEFAULT_RULES = AxisRules(
    {
        # -- parameter axes -------------------------------------------------
        "embed": ("pod", "data"),  # FSDP shard dim of every weight matrix
        "q_heads": "model",
        "kv_heads": None,  # kv_heads (8) < model axis (16): replicate
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",  # expert parallelism
        "expert_mlp": None,
        "ssm_heads": "model",
        "ssm_state": None,
        "conv_dim": "model",
        "layers": None,  # the stacked layer axis, never sharded
        # -- activation axes ------------------------------------------------
        "batch": ("pod", "data"),
        "seq": None,
        "kv_seq": None,
        "act_embed": None,
        "act_heads": "model",
        "act_mlp": "model",
        "act_vocab": "model",
    }
)

#: Long-context (batch=1) rules: sequence parallelism over "data".
LONG_CONTEXT_RULES = DEFAULT_RULES.replace(batch=None, seq="data", kv_seq="data")


def placements(logical: Sequence[str | None], mesh, rules: AxisRules = DEFAULT_RULES) -> tuple:
    """DTensor placements of a logical shape on ``mesh``: for each mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` that :meth:`AxisRules.resolve`
    gives it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    spec = rules.resolve(logical, mesh)
    owner: dict[str, int] = {}
    for d, axes in enumerate(spec):
        for a in (axes,) if isinstance(axes, str) else axes or ():
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in _axis_names(mesh))


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _map_logical(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_logical(fn, v) for k, v in tree.items()}
    if _is_logical(tree):
        return fn(tree)
    raise TypeError(f"not a logical-axis tree leaf: {tree!r}")


def shard_pytree_spec(logical_tree: Any, mesh, rules: AxisRules = DEFAULT_RULES) -> Any:
    """A tree of logical-axis tuples as a tree of placements."""
    return _map_logical(lambda logical: placements(logical, mesh, rules), logical_tree)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def replicate_like(t: torch.Tensor, ref):
    """``t`` (a tensor every rank computed alike: positions, a mask, fresh
    zeros) as a replicated DTensor on ``ref``'s mesh when ``ref`` is a
    DTensor, with no communication; ``t`` itself otherwise."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    from torch.distributed.tensor import Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def all_reduce(t: torch.Tensor, op: str, groups) -> torch.Tensor:
    """``t`` reduced (``op`` "sum" or "max") over each process group of
    ``groups`` in turn: functional collectives, so a dispatch mode sees
    them (the dry run counts their bytes).  Not differentiable."""
    import torch.distributed._functional_collectives as funcol

    for g in groups:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, g))
    return t


class _ReplicatedSum(torch.autograd.Function):
    """The sum over ``groups`` of a partial value whose result every rank
    then uses alike: the gradient of each rank's part is the result's."""

    @staticmethod
    def forward(ctx, t, groups):
        return all_reduce(t, "sum", groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


def replicated_sum(t: torch.Tensor, groups) -> torch.Tensor:
    """Differentiable sum of ``t`` over ``groups`` (see :class:`_ReplicatedSum`)."""
    return _ReplicatedSum.apply(t, tuple(groups)) if groups else t


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grads(*ts):
    """The tensors as they are, their gradients made contiguous: what a
    function run by ``local_map`` hands back as the local gradients of its
    inputs, which DTensor's view ops then reshape."""
    return tuple(_ContiguousGrad.apply(t) if t.requires_grad else t for t in ts)


def assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst.copy_(src), IN PLACE; for DTensors ``src`` is placed as ``dst``
    first and each rank copies its own shard."""
    if is_dtensor(dst):
        dst.to_local().copy_(src.redistribute(dst.device_mesh, dst.placements).to_local())
    else:
        dst.copy_(src)


def local_offsets(shape: Sequence[int], mesh, placements_) -> tuple[tuple, tuple]:
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` placed by ``placements_`` (DTensor's own split: a dim over
    n ranks in chunks of ceil(size / n), the last ones shorter or empty)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return compute_local_shape_and_global_offset(tuple(shape), mesh, tuple(placements_))


def local_zeros(shape: Sequence[int], dtype: torch.dtype, device, mesh, placements_):
    """A zeroed DTensor of global ``shape``: each rank allocates only its
    shard, on ``device`` (``meta`` allocates nothing)."""
    local, _ = local_offsets(shape, mesh, placements_)
    t = torch.zeros(local, dtype=dtype, device=device)
    return DTensor.from_local(t, mesh, tuple(placements_), run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def local_call(fn, args: tuple, in_placements: tuple, out_placements, mesh,
               in_grad_placements: tuple | None = None):
    """``fn`` on the local shards of ``args`` (DTensors, redistributed to
    ``in_placements`` first; None for an argument that is not a tensor),
    its outputs wrapped as DTensors placed by ``out_placements``: the
    kernel boundary under a mesh (``local_map``)."""
    from torch.distributed.tensor import Placement
    from torch.distributed.tensor.experimental import local_map

    if all(isinstance(a, Placement) for a in out_placements):  # one output: not a tuple
        out_placements = list(out_placements)
    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=in_grad_placements, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def shard_start(size: int, mesh, placements_, dim: int) -> tuple[int, int]:
    """(offset, length) of this rank's slice of a tensor dim of ``size``
    that ``placements_`` shard (DTensor's chunks, in mesh-dim order)."""
    from torch.distributed.tensor import Shard

    shape = [1] * (max([dim] + [a.dim for a in placements_ if isinstance(a, Shard)]) + 1)
    shape[dim] = size
    local, offset = local_offsets(shape, mesh, placements_)
    return offset[dim], local[dim]


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, and its gradient too: as
    GSPMD's sharding constraint binds both passes.  Without it a partial
    gradient (a sum still owed over "model") flows on through the products
    of the backward, each rank computing them at full width."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.redistribute(x.device_mesh, want) if tuple(x.placements) != want else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """Threaded through the model code: the mesh and the active rule table.

    ``none()`` is the unmeshed context: every method is then the identity,
    and the model code runs on plain tensors as before.
    """

    mesh: Any  # torch DeviceMesh or None
    rules: AxisRules = DEFAULT_RULES

    @staticmethod
    def none() -> "ShardingCtx":
        return ShardingCtx(mesh=None)

    def placements(self, logical: Sequence[str | None]) -> tuple:
        return placements(logical, self.mesh, self.rules)

    def constrain(self, x, logical: Sequence[str | None]):
        """``x`` redistributed to the placements the rules give ``logical``
        (the counterpart of ``with_sharding_constraint``); the identity
        off-mesh or on a plain tensor."""
        if self.mesh is None or not is_dtensor(x):
            return x
        want = self.placements(logical)
        if x.requires_grad:
            return _Constrain.apply(x, want)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(self.mesh, want)

    def weight(self, w, logical: Sequence[str | None]):
        """A weight gathered over its FSDP axes before a product (its
        ``"embed"`` dim replicated, its other dims placed by the rules),
        so that the product keeps the activations' batch shards: what
        GSPMD does with an FSDP weight.  The identity off-mesh."""
        if self.mesh is None or not is_dtensor(w):
            return w
        # the gradient keeps DTensor's own route back (a reduce-scatter of
        # the partial sums onto the FSDP shards)
        want = self.placements(tuple(None if a == "embed" else a for a in logical))
        return w if tuple(w.placements) == want else w.redistribute(self.mesh, want)

    def distribute(self, t: torch.Tensor, logical: Sequence[str | None]):
        """A full tensor, equal on every rank, as a DTensor placed by
        ``logical``: each rank keeps its own shard (no communication)."""
        if self.mesh is None:
            return t
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t, self.mesh, self.placements(logical), src_data_rank=None)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(_axis_names(mesh), tuple(mesh.shape)))


def check_divisible(name: str, shape: Sequence[int], logical: Sequence[str | None], mesh,
                    rules: AxisRules) -> None:
    """Raise ``ValueError`` when a dim of ``shape`` does not divide by the
    product of the mesh axes that ``rules`` resolve its logical axis to on
    ``mesh``: the input the reference's ``jit`` refuses, where DTensor
    would split it into uneven shards (some ranks empty).  Reads only the
    mesh's axis names and sizes."""
    sizes = mesh_axis_sizes(mesh)
    for d, axes in enumerate(rules.resolve(logical, mesh)):
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        n = math.prod(sizes[a] for a in axes)
        if shape[d] % n:
            raise ValueError(
                f"{name} of logical axes {tuple(logical)} is sharded over mesh axes {axes} "
                f"(product {n}) on dimension {d}, which implies that the global size of its "
                f"dimension {d} should be divisible by {n}, but it is equal to {shape[d]} "
                f"(full shape: {tuple(shape)})")


def rules_for(
    cfg,
    *,
    long_context: bool = False,
    decode_batch: bool = False,
    model_axis: int = 16,
) -> AxisRules:
    """Per-architecture sharding rules, as the reference's ``rules_for``.

    * MoE with fewer experts than the model axis (Mixtral's 8): the
      expert FFN dim over "model" (TP within each expert) instead of the
      expert axis.
    * MoE with many experts (Kimi 384, Jamba 16): expert parallelism,
      experts over "model", the expert FFN dim replicated in a shard.
    * long_context (batch=1 decode): sequence parallelism, batch
      unsharded, (kv_)seq over "data".
    * decode_batch: KV-cache-resident serving (decode_32k): the request
      batch over ("pod", "model") and the cache sequence over "data", so
      the cache is sharded over the whole mesh.
    """
    rules = LONG_CONTEXT_RULES if long_context else DEFAULT_RULES
    n_experts = getattr(cfg, "n_experts", 0)
    mode = getattr(cfg, "moe_ep", "auto")
    tp_experts = mode == "tp" or (mode == "auto" and 0 < n_experts < model_axis)
    if n_experts and tp_experts:
        rules = rules.replace(experts=None, expert_mlp="model")
    if decode_batch and not long_context:
        rules = rules.replace(batch=("pod", "model"), kv_seq="data")
    return rules


def serving_weight_rules(rules: AxisRules) -> AxisRules:
    """Serving layout with tensor-parallel static weights and a
    sequence-sharded cache: weights' embed replicated (heads, ffn and
    vocab over "model"); the KV cache's batch over ("pod", "data") and its
    kv_seq over "model"."""
    return rules.replace(embed=None, batch=("pod", "data"), kv_seq="model")
