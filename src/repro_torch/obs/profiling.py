"""Opt-in wall-clock profiling spans for the evaluator's host path, the
ops and the cache tiers.

Disabled by default: every probe is guarded by one module-level bool,
so the instrumented hot paths (the evaluator's plan, the fused
``sojourn_eval`` ops, the workload-cache tiers in
:mod:`repro_torch.core.policies`) pay a single attribute check when
profiling is off: no clock read and no profiler range.  Enable with
:func:`enable` or the ``REPRO_PROFILE=1`` environment variable.

Spans record into the process-wide default
:class:`~repro_torch.obs.metrics.MetricsRegistry` as
``prof.<name>.seconds`` histograms plus ``prof.<name>.calls``
counters, so anything that snapshots the registry surfaces kernel
latency next to cache hit/miss/eviction latency in one place.  A span
also opens a profiler range of its name (a ``RecordFunction``, as
``torch.profiler.record_function`` opens), so under ``torch.profiler``
it lands on the trace's host timeline beside the aten operations, the
CUDA kernels and the copies, on one clock.  The range is of function
scope, not user scope: a user-scope range would also get a range on the
card, from its first kernel to its last, which a reader of the trace
would count as device time.  :func:`count_bytes` and :func:`count` add
to a ``prof.<name>`` counter.  :func:`tick` / :func:`tock` are probes on
paths taken once a cache access; they reach the registry only.

The ``sojourn_eval`` ops copy their results to NumPy inside their spans,
which waits for the card, so an op's span holds its device time.
"""

from __future__ import annotations

import contextlib
import os
import time

from torch._C._profiler import _RecordFunctionFast

from repro_torch.obs import metrics

__all__ = ["enabled", "enable", "span", "count", "count_bytes", "tick", "tock"]

_ENABLED = os.environ.get("REPRO_PROFILE", "").strip().lower() not in (
    "", "0", "false", "off",
)
_OFF = contextlib.nullcontext()


def enabled() -> bool:
    return _ENABLED


def enable(on: bool = True) -> None:
    """Turn profiling spans on/off process-wide (overrides the env var)."""
    global _ENABLED
    _ENABLED = bool(on)


class _Span:
    __slots__ = ("name", "registry", "range", "t0")

    def __init__(self, name: str, registry: metrics.MetricsRegistry):
        self.name, self.registry = name, registry

    def __enter__(self):
        self.range = _RecordFunctionFast(self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        self.registry.histogram(f"prof.{self.name}.seconds").observe(seconds)
        self.registry.counter(f"prof.{self.name}.calls").inc()


def span(name: str, registry: metrics.MetricsRegistry | None = None):
    """Time a block into ``prof.<name>.seconds``, under a profiler range
    named ``name``, when profiling is on; a shared no-op otherwise."""
    if not _ENABLED:
        return _OFF
    return _Span(name, registry or metrics.get_registry())


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``prof.<name>`` when profiling is on."""
    if _ENABLED:
        metrics.get_registry().counter(f"prof.{name}").inc(n)


def count_bytes(name: str, tensors) -> None:
    """Add the bytes of ``tensors`` to the counter ``prof.<name>`` when
    profiling is on."""
    if _ENABLED:
        metrics.get_registry().counter(f"prof.{name}").inc(sum(t.nbytes for t in tensors))


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
