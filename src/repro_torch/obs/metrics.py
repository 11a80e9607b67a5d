"""Counters / gauges / histograms with a JSON-able snapshot surface.

The port's copy of ``repro/obs/metrics.py``.  One :class:`MetricsRegistry`
replaces ad-hoc result dicts: the DES
(:func:`repro_torch.core.simulator.simulate`) and the cluster manager
(:meth:`repro_torch.cluster.manager.ClusterManager.run`) populate a
registry passed by the caller through :func:`record_run_metrics`, the
profiling spans (:mod:`repro_torch.obs.profiling`) and the workload-cache
latency probes feed the process-wide default registry, and
``python -m repro_torch.obs.report`` dumps everything as one JSON
artifact; :func:`format_snapshot` renders a snapshot for CLI output.

Design constraints: metric updates are hot-path cheap (an attribute
add / list append), snapshots are pure reads, and everything in a
snapshot is JSON-serializable.
"""

from __future__ import annotations

import json

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "format_snapshot",
    "record_run_metrics",
]

#: Percentiles reported by histogram snapshots.
PERCENTILES = (50, 90, 95, 99)


class Counter:
    """Monotone event count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Value distribution; percentiles computed at snapshot time.

    Values are kept in a flat Python list (``observe``) or appended as
    numpy chunks (``observe_many``), so recording a million sojourns is
    one array append, not a million calls.
    """

    __slots__ = ("_values", "_chunks")

    def __init__(self):
        self._values: list[float] = []
        self._chunks: list[np.ndarray] = []

    def observe(self, v: float) -> None:
        self._values.append(float(v))

    def observe_many(self, values) -> None:
        arr = np.asarray(values, dtype=np.float64).ravel()
        if arr.size:
            self._chunks.append(arr)

    def _all(self) -> np.ndarray:
        parts = list(self._chunks)
        if self._values:
            parts.append(np.asarray(self._values))
        if not parts:
            return np.empty(0)
        return np.concatenate(parts)

    @property
    def count(self) -> int:
        return len(self._values) + sum(c.size for c in self._chunks)

    def snapshot(self) -> dict:
        vals = self._all()
        if vals.size == 0:
            return {"count": 0}
        out = {
            "count": int(vals.size),
            "mean": float(vals.mean()),
            "min": float(vals.min()),
            "max": float(vals.max()),
            "sum": float(vals.sum()),
        }
        pts = np.percentile(vals, PERCENTILES)
        out.update({f"p{p}": float(v) for p, v in zip(PERCENTILES, pts)})
        return out


class MetricsRegistry:
    """Name-keyed counters/gauges/histograms with get-or-create access.

    Names are dotted strings (``sojourn.successful``, ``cache.mem_hit``,
    ``prof.sojourn_eval.static.enum.xla.seconds``); a name is bound to
    the first type that claims it and re-registering as another type
    raises.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls()
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def clear(self) -> None:
        self._metrics.clear()

    def snapshot(self) -> dict:
        """JSON-able ``{"counters": ..., "gauges": ..., "histograms": ...}``."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.snapshot()
        return out

    def to_json(self, path: str | None = None, **extra) -> str:
        """Serialize the snapshot (plus ``extra`` top-level keys)."""
        doc = {**self.snapshot(), **extra}
        text = json.dumps(doc, indent=1, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text


def record_run_metrics(reg: MetricsRegistry, engine, arrivals, success) -> None:
    """Fill the standard scheduler-run metrics from a finished engine.

    Shared by both frontends so ``simulate(..., metrics=reg)`` and
    ``ClusterManager.run(metrics=reg)`` populate one catalog (see
    ``docs/observability.md``): success/cancel counts, sojourn
    percentiles split by outcome, makespan, server busy fraction
    (busy time over the time integral of the server target, so elastic
    resizes weigh correctly), and wasted work (failure-aborted stage
    time plus all service spent on jobs that end canceled).

    Counters/histograms accumulate across runs sharing a registry
    (policy sweeps); gauges are per-run, last write wins.
    """
    arrivals = np.asarray(arrivals, dtype=np.float64)
    success = np.asarray(success, dtype=bool)
    sojourn = engine.completion - arrivals
    done = ~np.isnan(sojourn)
    reg.counter("jobs.total").inc(len(arrivals))
    reg.counter("jobs.successful").inc(int((success & done).sum()))
    reg.counter("jobs.canceled").inc(int((~success & done).sum()))
    reg.histogram("sojourn.successful").observe_many(sojourn[success & done])
    reg.histogram("sojourn.canceled").observe_many(sojourn[~success & done])
    reg.gauge("run.makespan").set(engine.makespan)
    denom = engine.target_integral
    reg.gauge("servers.busy_fraction").set(
        engine.busy_time / denom if denom > 0 else 0.0
    )
    reg.gauge("work.busy_time").set(engine.busy_time)
    reg.gauge("work.aborted_time").set(engine.aborted_time)
    reg.gauge("work.wasted").set(
        engine.aborted_time + float(engine.service_time[~success].sum())
    )


_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (profiling spans, cache probes)."""
    return _DEFAULT


def format_snapshot(snapshot: dict, title: str = "metrics") -> str:
    """Render a snapshot as an aligned text block for CLI output."""
    lines = [f"== {title} =="]
    for name, v in snapshot.get("counters", {}).items():
        lines.append(f"  {name:44s} {v}")
    for name, v in snapshot.get("gauges", {}).items():
        lines.append(f"  {name:44s} {v:.6g}")
    for name, h in snapshot.get("histograms", {}).items():
        if h.get("count", 0) == 0:
            lines.append(f"  {name:44s} (empty)")
            continue
        lines.append(
            f"  {name:44s} n={h['count']} mean={h['mean']:.6g} "
            f"p50={h['p50']:.6g} p99={h['p99']:.6g} max={h['max']:.6g}"
        )
    return "\n".join(lines)
