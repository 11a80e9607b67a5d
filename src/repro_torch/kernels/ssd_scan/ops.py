"""Public SSD op with its backward.

The counterpart of ``repro/kernels/ssd_scan/ops.py``, with the device in
place of the ``impl`` dispatch: CUDA tensors launch the ``ssd_fwd``
kernel (or raise); CPU tensors run its plain version.  The public face
keeps the models' layout (B, S, H, P); the forward transposes into the
kernel's (B, H, S, P), forms ``dA = dt * A``, and adds the ``D * x`` skip
in the working type after the kernel's y, as ``_ssd_pallas_fwd`` does
(``ops.py:37-47``), so the numbers are those the TPU path computes.

``_SSDScan`` is the counterpart of ``_ssd_pallas`` with its custom VJP:
the backward recomputes through :func:`ref.ssd_chunked` under autograd
(``_ssd_pallas_bwd``, ``ops.py:50-58``), taking the cotangents of y and
of the final state and giving the gradients of x, dt, A, Bm, Cm and D.
The reference has no backward kernel, and neither has the port.

Two more routes, chosen by the inputs: DTensors (a meshed model) run the
op through ``local_map`` on each rank's shard, keeping the batch and head
shards (every other dim gathered first: the scan needs the whole
sequence); Bm and Cm, whose groups are not sharded, then get partial
gradients over the ranks that split the heads.  ``meta`` tensors (the dry
run) take :func:`ref.ssd_chunked`, whose loop over the chunks does the
kernel's products, for its shapes and FLOPs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.parallel.sharding import is_dtensor

__all__ = ["ssd_scan"]


def _forward(x, dt, A, Bm, Cm, D, chunk: int):
    xk = x.transpose(1, 2).contiguous()  # (B, H, S, P)
    dtk = dt.transpose(1, 2).contiguous()  # (B, H, S)
    dak = dtk * A[None, :, None].to(dtk.dtype)
    Bk = Bm.transpose(1, 2).contiguous()  # (B, G, S, N)
    Ck = Cm.transpose(1, 2).contiguous()
    y, state = K.ssd_fwd(xk, dtk, dak, Bk, Ck, chunk=chunk)
    y = y.transpose(1, 2) + (D[None, None, :, None] * x).to(y.dtype)
    return y.to(x.dtype), state


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, chunk: int):
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        ctx.chunk = chunk
        return _forward(x, dt, A, Bm, Cm, D, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            y, state = ssd_chunked(*inputs, chunk=ctx.chunk)
        return (*torch.autograd.grad((y, state), inputs, (dy, dstate)), None)


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H), softplus-ed, > 0
    A: torch.Tensor,  # (H,), negative
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    D: torch.Tensor,  # (H,)
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan; returns (y (B, S, H, P) in x's type, final state
    (B, H, N, P) float32), both differentiable in every input."""
    if is_dtensor(x):
        return _meshed(x, dt, A, Bm, Cm, D, chunk)
    if x.device.type == "meta":
        return ssd_chunked(x, dt, A, Bm, Cm, D, chunk=chunk)
    return _SSDScan.apply(x, dt, A, Bm, Cm, D, chunk)


def _meshed(x, dt, A, Bm, Cm, D, chunk: int):
    """:func:`ssd_scan` on DTensors, shard by shard (module doc)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.parallel.sharding import contiguous_grads, local_call

    xp = tuple(a if a in (Shard(0), Shard(2)) else Replicate() for a in x.placements)
    bp = tuple(Shard(0) if a == Shard(0) else Replicate() for a in xp)
    hp = tuple(Shard(0) if a == Shard(2) else Replicate() for a in xp)  # (H,) vectors
    bgrad = tuple(Partial() if a == Shard(2) else b for a, b in zip(xp, bp))
    hgrad = tuple(Partial() if a == Shard(0) else h for a, h in zip(xp, hp))
    state = tuple(Shard(0) if a == Shard(0) else Shard(1) if a == Shard(2) else Replicate()
                  for a in xp)

    def local(*args):
        return ssd_scan(*contiguous_grads(*args), chunk=chunk)

    return local_call(local, (x, dt, A, Bm, Cm, D), (xp, xp, hp, bp, bp, hp), (xp, state),
                      x.device_mesh, (xp, xp, hgrad, bgrad, bgrad, hgrad))
