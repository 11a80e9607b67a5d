"""Observability of the port: trace recording, metrics, profiling.

* :class:`TraceRecorder` (:mod:`repro_torch.obs.recorder`) — a batching
  DES observer exporting Chrome-trace/Perfetto JSON, per-server Gantt
  tables and queue-depth / utilization series from both frontends
  (``simulate(..., recorder=...)``, ``ClusterManager.run(recorder=...)``).
* :class:`MetricsRegistry` (:mod:`repro_torch.obs.metrics`) — counters /
  gauges / histograms with a JSON snapshot; both frontends populate it
  via ``metrics=`` (:func:`record_run_metrics`).
* :mod:`repro_torch.obs.profiling` — opt-in wall-clock spans around the
  evaluator's plan, the fused ``sojourn_eval`` ops (their kernel
  arguments and launches) and the workload-cache tiers, surfaced in the
  same registry snapshot and, as profiler ranges, on the
  ``torch.profiler`` timeline.

``python -m repro_torch.obs.report`` replays a synthetic Philly-trace
workload and writes the trace + metrics artifacts.

The recorder's names load on first use: :mod:`~repro_torch.obs.recorder`
imports :mod:`repro_torch.core`, whose evaluator imports the ops, which
import :mod:`~repro_torch.obs.profiling`; loading it here would make
importing the ops first a circular import.
"""

import importlib

from repro_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry,
    format_snapshot,
    get_registry,
    record_run_metrics,
)

_RECORDER = ("TraceRecorder", "validate_chrome_trace")


def __getattr__(name: str):
    if name in _RECORDER:
        return getattr(importlib.import_module("repro_torch.obs.recorder"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
