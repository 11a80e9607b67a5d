"""Public fused sojourn-evaluation op for static orders.

The counterpart of ``repro/kernels/sojourn_eval/ops.py``, with the device
in place of the ``impl`` dispatch: on the CUDA card (``device=None``)
every batch of orders launches the ``sojourn_enum`` / ``sojourn_mc``
kernels; with ``device="cpu"`` the same wrappers run their plain PyTorch
versions.  Entry modes:

* ``sojourn_eval(..., outcomes=None)`` — *exact enumeration* of all
  ``K = prod(M_i)`` combinations, decoded on the fly (never
  materialized).
* ``sojourn_eval(..., samples=(seed, n_samples))`` — *streaming Monte
  Carlo* from the counter-based Threefry stream, keyed by original job
  id, so every order under one seed sees identical outcomes.
* ``sojourn_eval(..., outcomes=, weights=)`` — *explicit outcomes*:
  Monte-Carlo samples or a shared exact table, ``(K, N)`` stop stages in
  original job indexing, through the ``sojourn_outcomes`` kernel.  The
  table goes to the device once, in that layout (see
  :func:`outcome_tables`), and the kernel evaluates a group of orders
  against one read of it.

Orders are evaluated in batches of the reference's size
(:func:`_order_batch`, at most 4096), each batch one launch, except for
explicit tables on the card, whose orders go to the kernel's wrapper in
one call (:func:`_outcome_batch`); the inputs' job axis is permuted on the
host per order (:func:`static_kernel_args`, :func:`outcomes_kernel_args`).

With :mod:`repro_torch.obs.profiling` on, each call is a span
``sojourn_eval.static.<mode>.<device>``, and inside it each batch's
kernel arguments a span ``ops.args`` and its kernel wrapper's call a span
``ops.launch``; the bytes of the inputs built on the host for the device
add to the counter ``prof.ops.h2d_bytes``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.sojourn_eval import kernel as K
from repro_torch.kernels.sojourn_eval.ref import mixed_radix_strides
from repro_torch.obs import profiling

__all__ = [
    "sojourn_eval",
    "static_kernel_args",
    "outcome_tables",
    "outcomes_kernel_args",
    "permuted_inputs",
]

#: Combination indices per tile of the reference's XLA scan (batch sizing).
XLA_TILE = 1 << 15
#: Combination indices per tile of the reference's Pallas kernels.
BLOCK_COMBOS = 8 * 128
#: Soft cap on bytes of per-tile intermediates (the reference's batch rule).
_TILE_BYTES_BUDGET = 256 << 20


def _order_batch(n_orders: int, tile: int, n: int) -> int:
    """Orders per launch, as the reference batches them."""
    per_order = tile * n * 8  # float64 worst case
    return max(1, min(n_orders, 4096, _TILE_BYTES_BUDGET // max(per_order, 1)))


def permuted_inputs(tables, orders_b: np.ndarray, device) -> list[torch.Tensor]:
    """Take the job axis of each host array along every order of the batch
    and move it to ``device``: float arrays as float64, integers as int32."""
    out = []
    for a in tables:
        a = np.take(a, orders_b, axis=0)
        dtype = np.float64 if np.issubdtype(a.dtype, np.floating) else np.int32
        out.append(torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=device))
    profiling.count_bytes("ops.h2d_bytes", out)
    return out


def sojourn_eval(
    sizes: np.ndarray,  # (N, M) padded cumulative sizes
    probs: np.ndarray,  # (N, M) padded stop probabilities
    num_stages: np.ndarray,  # (N,) stage counts
    orders: np.ndarray,  # (P, N) static orders
    *,
    outcomes: np.ndarray | None = None,
    weights: np.ndarray | None = None,
    samples: tuple[int, int] | None = None,  # (seed, n_samples) streamed MC
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """(E[sojourn successful], E[sojourn all]) per order, as NumPy (P,) arrays.

    When :mod:`repro_torch.obs.profiling` is enabled, each call is timed
    into a ``prof.sojourn_eval.static.<mode>.<device>.seconds`` span (the
    copy of the results to NumPy waits for the card, so the span is end
    to end).
    """
    if samples is not None and outcomes is not None:
        raise ValueError("samples= and outcomes= are mutually exclusive")
    if (outcomes is None) != (weights is None):
        raise ValueError("explicit outcomes need weights, and weights need outcomes")
    dev = resolve_device(device)
    mode = "mc" if samples is not None else ("enum" if outcomes is None else "outcomes")
    with profiling.span(f"sojourn_eval.static.{mode}.{dev.type}"):
        if outcomes is not None:
            return _outcomes_eval(sizes, num_stages, orders, outcomes, weights, dev)
        return _sojourn_eval(sizes, probs, num_stages, orders, samples, dev)


def static_kernel_args(sizes, probs, num_stages, orders_b, device, samples=None) -> tuple:
    """Positional arguments of :func:`kernel.sojourn_enum` (``samples=None``)
    or :func:`kernel.sojourn_mc` (``samples=(seed, n_samples)``) for one
    batch of orders ``orders_b`` (P, N) of a padded workload."""
    sizes = np.asarray(sizes, dtype=np.float64)
    probs = np.asarray(probs, dtype=np.float64)
    num_stages = np.asarray(num_stages, dtype=np.int64)
    radix = num_stages.astype(np.int32)
    orders_b = np.asarray(orders_b, dtype=np.int32)
    if samples is not None:
        cdf = np.cumsum(probs, axis=1)  # on the host: the reference's exact CDF
        job_ids = np.arange(sizes.shape[0], dtype=np.int32)
        tensors = permuted_inputs([sizes, cdf, radix, job_ids], orders_b, device)
        return (*tensors, int(samples[0]), int(samples[1]))
    strides = mixed_radix_strides(num_stages).astype(np.int32)
    tensors = permuted_inputs([sizes, probs, strides, radix], orders_b, device)
    return (*tensors, math.prod(int(m) for m in num_stages))


def outcome_tables(outcomes, weights, num_stages, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The explicit table as :func:`kernel.sojourn_outcomes` reads it:
    ``(K, N)`` int32 row-major outcomes, the evaluator's own layout, and
    ``(K,)`` float64 weights on ``device``.  A contiguous int32 table is
    neither copied nor transposed on the host (on the CPU the tensor shares
    its memory).  Raises unless every outcome lies in ``[0, M_i)``: checked
    on ``device``, one reduction, for an int32 table."""
    num_stages = np.asarray(num_stages, dtype=np.int64)
    outcomes = np.asarray(outcomes)
    weights = np.asarray(weights, dtype=np.float64)
    n = num_stages.shape[0]
    if outcomes.ndim != 2 or outcomes.shape[1] != n:
        raise ValueError(f"outcomes must be (K, {n}); got {outcomes.shape}")
    if weights.shape != (outcomes.shape[0],):
        raise ValueError(f"weights must be ({outcomes.shape[0]},); got {weights.shape}")
    bad = "every outcome must be a stage index in [0, M_i)"
    if outcomes.dtype != np.int32:  # a conversion anyway: checked before it wraps
        if outcomes.size and (outcomes.min() < 0 or np.any(outcomes >= num_stages[None, :])):
            raise ValueError(bad)
        outcomes = outcomes.astype(np.int32)
    table = torch.as_tensor(np.ascontiguousarray(outcomes), device=device)
    limit = torch.as_tensor(num_stages.astype(np.int32), device=device)
    weights = torch.as_tensor(weights, device=device)
    profiling.count_bytes("ops.h2d_bytes", (table, limit, weights))
    if table.numel() and bool(((table < 0) | (table >= limit)).any()):
        raise ValueError(bad)
    return table, weights


def outcomes_kernel_args(sizes, num_stages, orders_b, tables, device) -> tuple:
    """Positional arguments of :func:`kernel.sojourn_outcomes` for one batch
    of orders ``orders_b`` (P, N), with ``tables`` from :func:`outcome_tables`."""
    sizes = np.asarray(sizes, dtype=np.float64)
    radix = np.asarray(num_stages, dtype=np.int32)
    orders_b = np.asarray(orders_b, dtype=np.int32)
    job_ids = np.arange(sizes.shape[0], dtype=np.int32)
    return (*permuted_inputs([sizes, radix, job_ids], orders_b, device), *tables)


def _check_orders(orders, n: int) -> np.ndarray:
    orders = np.asarray(orders, dtype=np.int32)
    if orders.ndim != 2 or orders.shape[1] != n:
        raise ValueError(f"orders must be (P, {n}); got {orders.shape}")
    return orders


def _outcome_batch(dev, n_orders: int, k_total: int, n: int) -> int:
    """Orders a :func:`kernel.sojourn_outcomes` call takes: all of them on
    the card (its wrapper launches a group of orders against one read of
    the table, :func:`kernel.outcomes_plan`), the reference's batch as the
    plain version's memory cap elsewhere."""
    return n_orders if dev.type == "cuda" else _order_batch(n_orders, k_total, n)


def _outcomes_eval(sizes, num_stages, orders, outcomes, weights, dev):
    orders = _check_orders(orders, len(num_stages))
    with profiling.span("ops.args"):
        tables = outcome_tables(outcomes, weights, num_stages, dev)
    pb = _outcome_batch(dev, orders.shape[0], tables[1].shape[0], len(num_stages))
    parts = []
    for lo in range(0, orders.shape[0], pb):
        with profiling.span("ops.args"):
            args = outcomes_kernel_args(sizes, num_stages, orders[lo : lo + pb], tables, dev)
        with profiling.span("ops.launch"):
            parts.append(K.sojourn_outcomes(*args))
    e_succ = torch.cat([p[0] for p in parts]).cpu().numpy()
    e_all = torch.cat([p[1] for p in parts]).cpu().numpy()
    return e_succ, e_all


def _sojourn_eval(sizes, probs, num_stages, orders, samples, dev):
    num_stages = np.asarray(num_stages, dtype=np.int64)
    n = num_stages.shape[0]
    orders = _check_orders(orders, n)
    if samples is not None:
        count = int(samples[1])
        if count <= 0:
            raise ValueError(f"n_samples must be positive; got {count}")
        launch = K.sojourn_mc
    else:
        count = math.prod(int(m) for m in num_stages)
        launch = K.sojourn_enum
    tile = min(XLA_TILE, max(BLOCK_COMBOS, 1 << (count - 1).bit_length()))
    pb = _order_batch(orders.shape[0], tile, n)
    parts = []
    for lo in range(0, orders.shape[0], pb):
        with profiling.span("ops.args"):
            args = static_kernel_args(sizes, probs, num_stages, orders[lo : lo + pb], dev,
                                      samples)
        with profiling.span("ops.launch"):
            parts.append(launch(*args))
    e_succ = torch.cat([p[0] for p in parts]).cpu().numpy()
    e_all = torch.cat([p[1] for p in parts]).cpu().numpy()
    return e_succ, e_all
