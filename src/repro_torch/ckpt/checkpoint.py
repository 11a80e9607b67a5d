"""Checkpointing: async, atomic save/restore of parameter and optimizer trees.

The counterpart of ``repro/ckpt/checkpoint.py``, with its format, so that
a checkpoint the reference wrote of the same tree restores here:

* **Layout** — one ``step_<k>.npz`` per checkpoint, each leaf stored
  under its tree path (dict keys, ``.field`` for a dataclass field such
  as ``OptState.step``, the index inside a tuple, joined by ``/``), and a
  ``step_<k>.json`` manifest of shapes and dtypes.  bfloat16 leaves are
  stored as 2-byte raw data (``|V2``), as NumPy stores the reference's
  bfloat16 arrays; a Python int leaf (the optimizer step) as int32.
* **Atomicity** — both files are written as ``step_<k>.tmp.*`` and
  ``os.replace``d into place, so a failure mid-save never corrupts the
  latest checkpoint.
* **Async** — :meth:`CheckpointManager.save` copies every tensor to the
  host before it returns (the trainer updates its parameters in place
  right after), then writes on a background thread; :meth:`wait` joins
  it and raises what the write raised.
* **Keep-K GC** — only the ``keep`` newest checkpoints stay.
* **Meshed runs** — a DTensor leaf is gathered whole (``full_tensor()``,
  a collective every rank makes, leaf by leaf, on the calling thread) and
  only rank 0 writes, so a meshed run's checkpoint is the file an
  unmeshed run of the same values writes; a blocking save ends in a
  barrier.  A DTensor leaf of ``restore``'s target (on ``meta`` too)
  says where the leaf goes: every rank reads the whole array and keeps
  its shard, so one file restores onto any mesh or onto one device, as
  the reference's ``restore(..., shardings=)`` reshards.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import is_dtensor

__all__ = ["CheckpointManager"]

_SEP = "/"


def _map_named(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``tree`` with each leaf replaced by ``fn(name, leaf)``: nested dicts
    (sorted keys), dataclasses (fields in order) and tuples or lists."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, tree[k], (*path, str(k))) for k in sorted(tree)}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_named(fn, getattr(tree, f.name), (*path, "." + f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_named(fn, x, (*path, str(i))) for i, x in enumerate(tree))
    return fn(_SEP.join(path), tree)


def _named_leaves(tree: Any) -> list[tuple[str, Any]]:
    out = []
    _map_named(lambda name, leaf: out.append((name, leaf)), tree)
    return out


def _to_host(leaf: Any, keep: bool = True) -> np.ndarray | None:
    """A host copy of a leaf: bfloat16 as 2-byte raw data.  A DTensor is
    gathered whole first (every rank must call this); ``keep=False`` (a
    rank that does not write) drops the gathered value."""
    if is_dtensor(leaf):
        whole = leaf.full_tensor()
        return _to_host(whole) if keep else None
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _dtype_name(leaf: Any, host: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(host.dtype)


def _place(t: torch.Tensor, target) -> torch.Tensor:
    """The whole tensor ``t``, equal on every rank, as a DTensor placed as
    the DTensor ``target``: each rank keeps its own shard (a copy, so that
    the whole is freed)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    mesh, pl = target.device_mesh, target.placements
    local = distribute_tensor(t, mesh, pl, src_data_rank=None).to_local()
    if local.untyped_storage().nbytes() != local.nbytes:  # a view of the whole
        local = local.clone()
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=t.shape, stride=t.stride())


def _from_host(name: str, arr: np.ndarray, target: Any, device) -> Any:
    """The stored array as ``target``'s kind: a tensor of its dtype and
    shape on ``device`` (or on the target's own device), or an int; for a
    DTensor target, placed as it is (:func:`_place`)."""
    if not isinstance(target, torch.Tensor):
        return int(arr)
    if tuple(arr.shape) != tuple(target.shape):
        raise ValueError(f"{name}: stored shape {arr.shape} != target {tuple(target.shape)}")
    if arr.dtype.kind == "V":  # raw 2-byte data: bfloat16 as NumPy stores it
        if target.dtype != torch.bfloat16 or arr.dtype.itemsize != 2:
            raise TypeError(f"{name}: raw {arr.dtype} data cannot become {target.dtype}")
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(target.dtype)
    if is_dtensor(target):
        return _place(t.to(device if device is not None else target.device_mesh.device_type),
                      target)
    return t.to(device if device is not None else target.device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save ----------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Snapshot ``tree`` (params, optimizer state) at ``step``.  Of a
        meshed tree (DTensor leaves) every rank must call it: each leaf is
        gathered on every rank, rank 0 writes, and a blocking save ends
        when every rank has seen the file in place."""
        self.wait()
        named = _named_leaves(tree)
        meshed = any(is_dtensor(leaf) for _, leaf in named)
        writer = not meshed or dist.get_rank() == 0
        # leaf by leaf: a rank holds one gathered leaf at a time beyond its shards
        host = {name: _to_host(leaf, keep=writer) for name, leaf in named}
        if not writer:
            if blocking:
                dist.barrier()
            return
        manifest = {
            "step": int(step),
            "process_index": 0,
            "leaves": {
                name: {"shape": list(host[name].shape), "dtype": _dtype_name(leaf, host[name])}
                for name, leaf in named
            },
        }

        def write():
            tmp = os.path.join(self.directory, f"step_{step}.tmp.npz")
            final = os.path.join(self.directory, f"step_{step}.npz")
            mtmp = os.path.join(self.directory, f"step_{step}.tmp.json")
            mfinal = os.path.join(self.directory, f"step_{step}.json")
            np.savez(tmp, **host)
            with open(mtmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, final)
            os.replace(mtmp, mfinal)
            self._gc()

        if blocking:
            write()
            if meshed:
                dist.barrier()
            return

        def run():
            try:
                write()
            except BaseException as exc:  # handed to wait(), which raises it
                self._error = exc

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the background write, raising what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from error

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            for ext in (".npz", ".json"):
                try:
                    os.remove(os.path.join(self.directory, f"step_{s}{ext}"))
                except FileNotFoundError:
                    pass

    # -- restore ---------------------------------------------------------

    def all_steps(self) -> list[int]:
        steps = []
        for fn in os.listdir(self.directory):
            if fn.startswith("step_") and fn.endswith(".npz") and ".tmp" not in fn:
                steps.append(int(fn[len("step_") : -len(".npz")]))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any, device=None) -> Any:
        """Load ``step`` onto the structure of ``target``, whose tensor
        leaves (on any device, ``meta`` included) give each leaf's dtype
        and shape; tensors land on ``device``, or on their target's
        device when it is None.  A DTensor leaf of ``target`` gives its
        mesh and placements too: the leaf comes back placed so, each rank
        holding its shard."""
        self.wait()
        path = os.path.join(self.directory, f"step_{step}.npz")
        with np.load(path) as data:
            return _map_named(lambda name, leaf: _from_host(name, data[name], leaf, device),
                              target)
