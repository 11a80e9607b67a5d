"""Opt-in wall-clock profiling spans for kernels and cache tiers.

Disabled by default: every probe is guarded by one module-level bool,
so the instrumented hot paths (the fused ``sojourn_eval`` ops, the
workload-cache tiers in :mod:`repro_torch.core.policies`) pay a single
attribute check when profiling is off.  Enable with
:func:`enable` or the ``REPRO_PROFILE=1`` environment variable.

Spans record into the process-wide default
:class:`~repro_torch.obs.metrics.MetricsRegistry` as
``prof.<name>.seconds`` histograms plus ``prof.<name>.calls``
counters, so anything that snapshots the registry surfaces kernel
latency next to cache hit/miss/eviction latency in one place.

For CUDA work use :func:`block` inside a span to charge asynchronous
launches to the span that started them (``torch.cuda.synchronize``);
the ``sojourn_eval`` ops copy their results to numpy inside their
spans, which waits for the card implicitly.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch

from repro_torch.obs import metrics

__all__ = ["enabled", "enable", "span", "block", "tick", "tock"]

_ENABLED = os.environ.get("REPRO_PROFILE", "").strip().lower() not in (
    "", "0", "false", "off",
)


def enabled() -> bool:
    return _ENABLED


def enable(on: bool = True) -> None:
    """Turn profiling spans on/off process-wide (overrides the env var)."""
    global _ENABLED
    _ENABLED = bool(on)


@contextmanager
def span(name: str, registry: metrics.MetricsRegistry | None = None):
    """Time a block into ``prof.<name>.seconds`` when profiling is on."""
    if not _ENABLED:
        yield
        return
    reg = registry or metrics.get_registry()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        reg.histogram(f"prof.{name}.seconds").observe(time.perf_counter() - t0)
        reg.counter(f"prof.{name}.calls").inc()


def block(x):
    """``torch.cuda.synchronize`` under profiling; identity otherwise.

    Wrap a span's result so device-async work is charged to the span
    that launched it instead of the first later host sync.
    """
    if _ENABLED and torch.cuda.is_available():
        torch.cuda.synchronize()
    return x


def tick() -> float:
    """Start time for a hand-rolled probe; 0.0 when profiling is off.

    ``tick``/``tock`` avoid context-manager overhead on paths probed
    per cache access.
    """
    return time.perf_counter() if _ENABLED else 0.0


def tock(name: str, t0: float) -> None:
    """Close a :func:`tick` probe into ``prof.<name>.seconds``."""
    if _ENABLED and t0:
        reg = metrics.get_registry()
        reg.histogram(f"prof.{name}.seconds").observe(time.perf_counter() - t0)
        reg.counter(f"prof.{name}.calls").inc()
