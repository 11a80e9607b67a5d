"""Roofline terms of a dry-run cell on a model of the H100 machine.

The counterpart of ``repro/launch/roofline.py``.  Three terms per
(arch x shape x mesh), all in seconds:

    compute    = FLOPs_per_chip / peak_flops
    memory     = bytes_per_chip / hbm_bw
    collective = collective_bytes_per_chip / link_bw

They model a machine of H100 SXM cards; they are not measurements.
:class:`Hardware` holds the card's published peaks (NVIDIA's H100 SXM
datasheet): 989e12 dense bf16 FLOP/s on the tensor cores and 3.35e12
bytes/s of HBM3, the numbers ``chip_smoke.py``'s bounds use; and
``link_bw`` = 50e9 bytes/s a GPU a direction, one 400 Gb/s NDR InfiniBand
link, which any mesh axis wider than a node of 8 GPUs crosses (the
production meshes' axes are 16 wide).

There is no compiled HLO to read: the dry run executes the meshed
program eagerly on ``meta`` tensors under three dispatch modes, which
see each rank's LOCAL ops (a mode hands DTensor ops back, so DTensor
first lowers them into local ops and collectives, as ``CommDebugMode``
does; the global-shape runs of DTensor's shape propagation, on fake
tensors, are not counted):

* :class:`FlopCount` sums the FLOPs of every local op that PyTorch's
  ``FlopCounterMode`` registry counts (matrix products, attention,
  convolutions): the work one rank executes, replicated work included;
* :class:`CollectiveBytes` sums the RESULT bytes of each
  ``_c10d_functional`` collective by kind (all-gather, all-reduce,
  reduce-scatter, all-to-all), the reference's result-shape convention;
  :func:`roofline_terms` counts an all-reduce twice on the wire (a ring's
  reduce-scatter and all-gather);
* :class:`HbmBytes` sums the local input and output bytes of every aten
  op that is not a view, with no fusion.  That overstates the bytes the
  card moves: a fused or cached intermediate is counted each time an op
  reads or writes it, and the plain attention of the ``meta`` route
  counts its (S x S) scores, which the ``flash_fwd`` kernel keeps on chip.
"""

from __future__ import annotations

import dataclasses
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["HW", "Hardware", "COLLECTIVES", "FlopCount", "CollectiveBytes", "HbmBytes",
           "roofline_terms", "model_flops", "RooflineReport"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    peak_flops: float = 989e12  # dense bf16 FLOP/s a card
    hbm_bw: float = 3.35e12  # bytes/s
    link_bw: float = 50e9  # bytes/s a GPU a direction across nodes (one NDR link)


HW = Hardware()

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")

_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _fake(out) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    if isinstance(out, torch.Tensor):
        return isinstance(out, FakeTensor)
    return any(isinstance(t, FakeTensor) for t in tree_leaves(out))


def _has_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


class _LocalMode(TorchDispatchMode):
    """A dispatch mode that counts local ops only: DTensor ops are handed
    back (``NotImplemented``) and come back as local ops."""

    def _count(self, func, args, kwargs, out) -> None:
        raise NotImplementedError

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if _has_dtensor(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _fake(out):  # DTensor's shape propagation runs global shapes on fake tensors
            self._count(func, args, kwargs, out)
        return out


class FlopCount(_LocalMode):
    """FLOPs of the local ops, by ``torch.utils.flop_counter``'s registry."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = 0

    def _count(self, func, args, kwargs, out):
        fn = self.registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += int(fn(*args, **kwargs, out_val=out))


class CollectiveBytes(_LocalMode):
    """Result bytes of each functional collective, by kind."""

    def __init__(self):
        super().__init__()
        self.bytes = {k: 0 for k in COLLECTIVES}
        self.calls = {k: 0 for k in COLLECTIVES}

    def _count(self, func, args, kwargs, out):
        ns = func.namespace
        if ns not in ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd"):
            return
        kind = _KIND.get(func._overloadpacket.__name__)
        if kind is None:
            return
        self.bytes[kind] += sum(_nbytes(t) for t in tree_leaves(out))
        self.calls[kind] += 1


class HbmBytes(_LocalMode):
    """Input plus output bytes of every local aten op that is not a view."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def _count(self, func, args, kwargs, out):
        if func.is_view or func.namespace != "aten":
            return
        self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in tree_leaves(out))


def roofline_terms(flops_per_chip: float, bytes_per_chip: float, coll_bytes: dict,
                   hw: Hardware = HW) -> dict:
    """The three terms, the dominant one, the bound (their max) and the
    compute share of it; an all-reduce counts twice on the wire."""
    coll_total = sum(coll_bytes.values())
    coll_wire = coll_total + coll_bytes.get("all-reduce", 0)
    terms = {"compute": flops_per_chip / hw.peak_flops,
             "memory": bytes_per_chip / hw.hbm_bw,
             "collective": coll_wire / hw.link_bw}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return {
        **terms,
        "dominant": dominant,
        "step_time_lower_bound": bound,
        "roofline_fraction": terms["compute"] / bound if bound > 0 else 0.0,
        "collective_bytes": dict(coll_bytes),
        "collective_wire_bytes": coll_wire,
    }


def model_flops(cfg, shape_spec, mode: str) -> float:
    """Analytic useful FLOPs: 6 N_active tokens (train), 2 N_active tokens
    (prefill), 2 N_active a sequence (decode: one token each)."""
    n_active = cfg.param_count(active_only=True)
    if mode == "train":
        return 6.0 * n_active * shape_spec.global_batch * shape_spec.seq_len
    if mode == "prefill":
        return 2.0 * n_active * shape_spec.global_batch * shape_spec.seq_len
    return 2.0 * n_active * shape_spec.global_batch


@dataclasses.dataclass
class RooflineReport:
    """The per-cell dry-run JSONs as the roofline table (a row of the
    serving-weight layout marked ``tp`` in its mesh column)."""

    rows: list[dict]

    @staticmethod
    def load(paths: list[str]) -> "RooflineReport":
        rows = []
        for p in paths:
            with open(p) as f:
                rows.append(json.load(f))
        rows.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"], r.get("tp_weights", False)))
        return RooflineReport(rows)

    def to_markdown(self) -> str:
        hdr = (
            "| arch | shape | mesh | compute (ms) | memory (ms) | collective (ms) "
            "| dominant | roofline frac | useful/executed flops | state GiB/chip |\n"
            "|---|---|---|---|---|---|---|---|---|---|\n"
        )
        lines = []
        for r in self.rows:
            t = r["roofline"]
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']}{' tp' if r.get('tp_weights') else ''} "
                f"| {t['compute']*1e3:.2f} | {t['memory']*1e3:.2f} "
                f"| {t['collective']*1e3:.2f} | {t['dominant']} "
                f"| {t['roofline_fraction']:.2f} "
                f"| {r.get('useful_flops_ratio', float('nan')):.2f} "
                f"| {r.get('state_bytes_per_chip', 0)/2**30:.2f} |"
            )
        return hdr + "\n".join(lines)
