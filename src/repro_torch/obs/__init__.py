"""Observability of the port: metrics registry and profiling spans.

* :class:`MetricsRegistry` (:mod:`repro_torch.obs.metrics`) — counters /
  gauges / histograms with a JSON snapshot.
* :mod:`repro_torch.obs.profiling` — opt-in wall-clock spans around the
  fused ``sojourn_eval`` ops and the workload-cache tiers, surfaced in
  the same registry snapshot.
"""

from repro_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry,
    format_snapshot,
    get_registry,
)
