"""Parameter spec trees: shapes + logical axes + initializers.

The counterpart of ``repro/models/init.py``.  Models are spec-first:
every module contributes a nested dict of :class:`ParamSpec`;
:func:`materialize` turns a spec tree into tensors on an explicit device
from an explicit ``torch.Generator``, and :func:`from_reference` carries
a parameter tree of the JAX package (as NumPy arrays) across, so that
both packages compute with the same numbers.  The logical axes place
each leaf on a mesh (:mod:`repro_torch.parallel.sharding`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

__all__ = ["ParamSpec", "materialize", "from_reference", "tree_map", "tree_leaves",
           "tree_bytes"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...]
    init: str = "fan_in"  # fan_in | normal | zeros | ones
    scale: float = 1.0
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} vs logical {self.logical}")


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to the leaves of nested dicts (and the matching leaves
    of ``rest``), keeping the structure; keys are visited sorted."""
    if isinstance(tree, dict):
        for other in rest:
            if not isinstance(other, dict) or sorted(other) != sorted(tree):
                raise ValueError(f"tree structures differ: {sorted(tree)}")
        return {k: tree_map(fn, tree[k], *(o[k] for o in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of nested dicts, in the order :func:`tree_map` visits them."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_bytes(tree: Any) -> int:
    """Bytes held by the tensors of a tree."""
    total = 0

    def add(t):
        nonlocal total
        total += t.numel() * t.element_size()

    tree_map(add, tree)
    return total


def _std(spec: ParamSpec) -> float:
    if spec.init == "normal":
        return spec.scale
    if spec.init == "fan_in":
        fan_in = spec.shape[0] if len(spec.shape) == 1 else math.prod(spec.shape[:-1])
        # stacked layers: the leading "layers" dim is not fan-in
        if spec.logical and spec.logical[0] == "layers" and len(spec.shape) > 2:
            fan_in = math.prod(spec.shape[1:-1])
        return spec.scale / math.sqrt(max(fan_in, 1))
    raise ValueError(f"unknown init {spec.init!r}")


#: Largest number of elements drawn at once: a leaf above it is drawn in
#: runs of this many elements (in its memory order), so that drawing the
#: largest leaf (Mixtral's stacked experts, 9.7e9 elements at 12 layers)
#: never holds a float32 copy of the whole leaf.
DRAW_ELEMENTS = 1 << 27


def _init_one(spec: ParamSpec, generator: torch.Generator, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    std = _std(spec)
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    flat = out.view(-1)
    for start in range(0, flat.numel(), DRAW_ELEMENTS):
        n = min(DRAW_ELEMENTS, flat.numel() - start)
        flat[start:start + n] = torch.randn(n, generator=generator, dtype=torch.float32,
                                            device=device).mul_(std)
    return out


def materialize(spec_tree: Any, generator: torch.Generator, device, place=None) -> Any:
    """Instantiate every ParamSpec leaf on ``device``, drawing from
    ``generator`` (which must live on ``device``) leaf by leaf in sorted
    key order, and a large leaf in runs of :data:`DRAW_ELEMENTS`.  The
    numbers differ from the JAX package's for the same seed;
    :func:`from_reference` is how the tests share weights.
    ``place(tensor, spec)``, if given, takes each leaf as soon as it is
    drawn (a meshed init keeps only its shard of it)."""
    if place is None:
        return tree_map(lambda s: _init_one(s, generator, device), spec_tree)
    return tree_map(lambda s: place(_init_one(s, generator, device), s), spec_tree)


def _to_torch(arr, spec: ParamSpec, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(spec.shape):
        raise ValueError(f"parameter shape {arr.shape} != spec {spec.shape}")
    if arr.dtype.name == "bfloat16":  # ml_dtypes: through float32, exactly
        arr = arr.astype(np.float32)
    return torch.tensor(arr, device=device).to(spec.dtype)


def from_reference(params_numpy: Any, cfg, device="cpu") -> Any:
    """The JAX package's parameter tree (nested dicts of arrays, e.g. from
    ``repro.models.transformer.init_params`` through ``np.asarray``) as
    this package's tree for ``cfg``: same keys, stacked ``layers``, padded
    vocabulary, each leaf in the dtype of its :class:`ParamSpec`."""
    from repro_torch.models.transformer import param_specs

    return tree_map(lambda spec, arr: _to_torch(arr, spec, device),
                    param_specs(cfg), params_numpy)
