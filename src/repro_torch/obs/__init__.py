"""Observability of the port: trace recording, metrics, profiling.

* :class:`TraceRecorder` (:mod:`repro_torch.obs.recorder`) — a batching
  DES observer exporting Chrome-trace/Perfetto JSON, per-server Gantt
  tables and queue-depth / utilization series from both frontends
  (``simulate(..., recorder=...)``, ``ClusterManager.run(recorder=...)``).
* :class:`MetricsRegistry` (:mod:`repro_torch.obs.metrics`) — counters /
  gauges / histograms with a JSON snapshot; both frontends populate it
  via ``metrics=`` (:func:`record_run_metrics`).
* :mod:`repro_torch.obs.profiling` — opt-in wall-clock spans around the
  fused ``sojourn_eval`` ops and the workload-cache tiers, surfaced in
  the same registry snapshot.

``python -m repro_torch.obs.report`` replays a synthetic Philly-trace
workload and writes the trace + metrics artifacts.
"""

from repro_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry,
    format_snapshot,
    get_registry,
    record_run_metrics,
)
from repro_torch.obs.recorder import TraceRecorder, validate_chrome_trace  # noqa: F401
