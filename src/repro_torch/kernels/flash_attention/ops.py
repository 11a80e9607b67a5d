"""Public fused-attention op with its backward.

The counterpart of ``repro/kernels/flash_attention/ops.py``, with the
device in place of the ``impl`` dispatch: CUDA tensors launch the
``flash_fwd``, ``flash_dkv`` and ``flash_dq`` kernels (or raise); CPU
tensors run their plain versions.  ``_FlashAttention`` is the
counterpart of ``_flash_pallas`` with ``_flash_fwd_rule`` and
``_flash_bwd_rule`` (``ops.py:43-75`` there): the forward saves q, k, v,
O and the LSE; the backward forms ``delta = rowsum(dO * O)`` in float32
(plain PyTorch, as the reference computes it outside any kernel), then
runs ``flash_dkv`` and ``flash_dq`` and casts the float32 gradients to
the input types.  The public face keeps the models' (B, S, H, D) layout;
the kernels' is (B, H, S, D), so q, k and v are transposed into
contiguous copies and O back, and autograd carries the gradients through
the same transposes.

Two more routes, chosen by the inputs and named here:

* DTensors (a meshed model): the kernels never see one.  The op runs
  through ``local_map`` on each rank's shard, with q's batch and head
  shards kept and k, v following q's batch shards (every other dim
  gathered first), so the same kernel (its plain version on the CPU)
  runs on the local batch and heads.  With the query heads sharded and
  the KV heads not, a rank's heads take their KV heads by GLOBAL head
  index (:func:`kv_heads_for`), and the gradients of k and v are partial
  sums over the ranks that share them.
* ``meta`` tensors (the dry run's shape propagation): the plain
  :func:`~repro_torch.kernels.flash_attention.ref.ref_attention`, which
  autograd differentiates; nothing is computed.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import ref_attention
from repro_torch.parallel.sharding import is_dtensor

__all__ = ["flash_attention", "kv_heads_for"]


def _to_kernel(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> contiguous (B, H, S, D)."""
    return x.transpose(1, 2).contiguous()


class _FlashAttention(torch.autograd.Function):
    """O = attention(q, k, v) in the kernels' (B, H, S, D) layout."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool, window: int | None):
        o, lse = K.flash_fwd(q, k, v, scale=scale, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = {"scale": scale, "causal": causal, "window": window}
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dk, dv = K.flash_dkv(q, k, v, do, lse, delta, **ctx.args)
        dq = K.flash_dq(q, k, v, do, lse, delta, **ctx.args)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Fused multi-head attention; O (B, Sq, Hq, D) in q's type,
    differentiable in q, k and v."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if is_dtensor(q):
        return _meshed(q, k, v, causal, window, scale)
    if q.device.type == "meta":
        return ref_attention(q, k, v, causal=causal, window=window, scale=scale)
    o = _FlashAttention.apply(_to_kernel(q), _to_kernel(k), _to_kernel(v), scale, causal,
                              window)
    return o.transpose(1, 2)


def kv_heads_for(k: torch.Tensor, v: torch.Tensor, head_off: int, hq_loc: int, group: int,
                 *, repeat: bool = False):
    """The KV heads (dim 2 of (B, S, Hkv, D) k and v) of the global query
    heads ``head_off`` to ``head_off + hq_loc - 1`` under a GQA group of
    ``group``: a slice of whole groups (or of one head shared by them all)
    where the heads allow it, so the kernel's own GQA maps them; else, or
    with ``repeat``, one KV head a query head."""
    kvh = [(head_off + i) // group for i in range(hq_loc)]
    lo, n = kvh[0], kvh[-1] - kvh[0] + 1
    if repeat or hq_loc % n or kvh != [lo + i // (hq_loc // n) for i in range(hq_loc)]:
        idx = torch.tensor(kvh, device=k.device)
        return k.index_select(2, idx), v.index_select(2, idx)
    if n == k.shape[2]:
        return k, v
    return k[:, :, lo:lo + n], v[:, :, lo:lo + n]


def _meshed(q, k, v, causal: bool, window: int | None, scale: float):
    """:func:`flash_attention` on DTensors, shard by shard (module doc)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.parallel.sharding import local_call, shard_start

    mesh = q.device_mesh
    qpl = tuple(a if a in (Shard(0), Shard(2)) else Replicate() for a in q.placements)
    kpl = tuple(Shard(0) if a == Shard(0) else Replicate() for a in qpl)
    kgrad = tuple(Partial() if a == Shard(2) else b for a, b in zip(qpl, kpl))
    head_off, hq_loc = shard_start(q.shape[2], mesh, qpl, 2)
    group = q.shape[2] // k.shape[2]

    def local(q, k, v):
        k, v = kv_heads_for(k, v, head_off, hq_loc, group)
        return flash_attention(q, k, v, causal=causal, window=window, scale=scale)

    return local_call(local, (q, k, v), (qpl, kpl, kpl), qpl, mesh, (qpl, kgrad, kgrad))
