"""Batching trace recorder + Chrome-trace / Gantt / time-series export.

:class:`TraceRecorder` implements the engine's batched observer
protocol (:class:`repro_torch.core.des.events.EngineObserver`): the engine
hands it flat record tuples in batches, and the recorder's hot path is
a single ``list.extend`` per batch — tracing a million-event replay
costs one Python call per ``batch_size`` events on top of the engine's
tuple appends.

Exports (all derived lazily, after the run):

* :meth:`to_chrome_trace` — Chrome trace-event JSON, loadable in
  Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.  Stage
  executions become complete ("ph": "X") slices on per-server tracks,
  arrivals/failures/restarts/resizes become instants, and queue depth /
  busy servers / target become counter tracks.
* :meth:`gantt` — a per-server Gantt table (one row per executed stage
  span, with how the span ended).
* :meth:`queue_depth_series` / :meth:`utilization_series` — step-wise
  time series straight from the per-record state snapshots.

Server lanes are assigned post-hoc (the pool tracks counts, not
identities): a min-heap of free lanes replays dispatch/release order,
so lane count equals the peak concurrency and re-used servers share
lanes deterministically.

Both frontends emit the identical schema — ``simulate(...,
recorder=...)`` and ``ClusterManager.run(recorder=...)`` differ only in
which event kinds appear (the DES never emits failure/restart/resize).

The port's counterpart of ``repro/obs/recorder.py``: the same records
give the same Chrome trace, down to the schema name.
"""

from __future__ import annotations

import heapq
import json

import numpy as np

from repro_torch.core.des.events import (
    EV_CANCEL,
    EV_COMPLETE,
    EV_DISPATCH,
    EV_RESIZE,
    EV_RESTART,
    EV_STAGE_DONE,
    EVENT_NAMES,
    EngineObserver,
    TraceEvent,
)

__all__ = ["TraceRecorder", "validate_chrome_trace"]

#: Record-tuple field offsets (see ``events.RECORD_FIELDS``).
_T, _KIND, _JOB, _STAGE, _VALUE, _QLEN, _BUSY, _FREE, _TARGET = range(9)

#: Events that end the recorded job's in-flight stage span.
_RELEASE_KINDS = (EV_STAGE_DONE, EV_COMPLETE, EV_CANCEL, EV_RESTART)


class TraceRecorder(EngineObserver):
    """Buffer engine trace records; export traces, tables and series.

    One recorder may span several runs (e.g. a policy sweep); records
    accumulate until :meth:`clear`.  Attach via
    ``simulate(..., recorder=rec)`` or
    ``ClusterManager.run(recorder=rec)``.
    """

    def __init__(self, batch_size: int = 4096):
        self.batch_size = int(batch_size)
        self.records: list[tuple] = []
        self.n_runs = 0

    # -- observer protocol ------------------------------------------------

    def on_events(self, engine, records: list[tuple]) -> None:
        self.records.extend(records)

    def on_run_end(self, engine) -> None:
        self.n_runs += 1

    # -- views ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.records)

    def clear(self) -> None:
        self.records.clear()
        self.n_runs = 0

    def events(self) -> list[TraceEvent]:
        """Typed decode of every record (allocates; not the hot path)."""
        return [TraceEvent.from_record(r) for r in self.records]

    def counts(self) -> dict[str, int]:
        """Record count per event kind name."""
        out = dict.fromkeys(EVENT_NAMES, 0)
        for r in self.records:
            out[EVENT_NAMES[r[_KIND]]] += 1
        return out

    def queue_depth_series(self) -> np.ndarray:
        """(T, 2) array of (time, ready-queue length) after each event."""
        if not self.records:
            return np.empty((0, 2))
        return np.array([(r[_T], r[_QLEN]) for r in self.records])

    def utilization_series(self) -> np.ndarray:
        """(T, 4) array of (time, busy, free, target) after each event."""
        if not self.records:
            return np.empty((0, 4))
        return np.array(
            [(r[_T], r[_BUSY], r[_FREE], r[_TARGET]) for r in self.records]
        )

    # -- Gantt ------------------------------------------------------------

    def gantt(self) -> list[dict]:
        """Per-server stage spans: one row per dispatch→release pair.

        Rows: ``{"server", "job", "stage", "start", "end", "end_kind"}``
        with ``end_kind`` one of ``stage_done`` (survived, requeued),
        ``complete`` (success exit), ``cancel`` (early-termination
        exit), ``restart`` (failure abort — the stage's work was lost).
        Spans still open at the end of the records (only possible on a
        truncated trace) are dropped.
        """
        rows = []
        free_lanes: list[int] = []
        next_lane = 0
        open_spans: dict[int, tuple[float, int, int]] = {}  # job -> (t0, lane, stage)
        for r in self.records:
            kind = r[_KIND]
            if kind == EV_DISPATCH:
                lane = heapq.heappop(free_lanes) if free_lanes else next_lane
                if lane == next_lane:
                    next_lane += 1
                open_spans[r[_JOB]] = (r[_T], lane, r[_STAGE])
            elif kind in _RELEASE_KINDS and r[_JOB] in open_spans:
                t0, lane, stage = open_spans.pop(r[_JOB])
                heapq.heappush(free_lanes, lane)
                rows.append({
                    "server": lane,
                    "job": r[_JOB],
                    "stage": stage,
                    "start": t0,
                    "end": r[_T],
                    "end_kind": EVENT_NAMES[kind],
                })
        return rows

    # -- Chrome trace-event / Perfetto export -----------------------------

    def to_chrome_trace(self, time_scale: float = 1e6) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable).

        ``time_scale`` converts engine time units to the format's
        microseconds (default: engine time is seconds).
        """
        trace_events = [
            {"ph": "M", "pid": 0, "name": "process_name",
             "args": {"name": "repro-des"}},
        ]
        named_lanes = set()
        for row in self.gantt():
            lane = row["server"]
            if lane not in named_lanes:
                named_lanes.add(lane)
                trace_events.append({
                    "ph": "M", "pid": 0, "tid": lane, "name": "thread_name",
                    "args": {"name": f"server-{lane}"},
                })
            trace_events.append({
                "ph": "X",
                "name": f"job{row['job']}/stage{row['stage']}",
                "cat": "stage",
                "pid": 0,
                "tid": lane,
                "ts": row["start"] * time_scale,
                "dur": (row["end"] - row["start"]) * time_scale,
                "args": {"job": row["job"], "stage": row["stage"],
                         "end_kind": row["end_kind"]},
            })
        instant_kinds = (EV_RESTART, EV_RESIZE, EV_COMPLETE, EV_CANCEL)
        for r in self.records:
            kind = r[_KIND]
            if kind in instant_kinds:
                trace_events.append({
                    "ph": "i", "s": "g",
                    "name": EVENT_NAMES[kind],
                    "cat": "scheduler",
                    "pid": 0, "tid": 0,
                    "ts": r[_T] * time_scale,
                    "args": {"job": r[_JOB], "value": r[_VALUE]},
                })
            # counter tracks: queue depth and server occupancy per event
            trace_events.append({
                "ph": "C", "name": "queue_depth", "pid": 0,
                "ts": r[_T] * time_scale, "args": {"jobs": r[_QLEN]},
            })
            trace_events.append({
                "ph": "C", "name": "servers", "pid": 0,
                "ts": r[_T] * time_scale,
                "args": {"busy": r[_BUSY], "free": r[_FREE],
                         "target": r[_TARGET]},
            })
        return {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": {
                # the reference's schema name: a trace of either package
                # is the same document
                "schema": "repro.obs/chrome-trace/v1",
                "runs": self.n_runs,
                "records": len(self.records),
                "counts": self.counts(),
            },
        }

    def write_chrome_trace(self, path: str, time_scale: float = 1e6) -> dict:
        """Export :meth:`to_chrome_trace` to ``path``; returns the object."""
        obj = self.to_chrome_trace(time_scale)
        with open(path, "w") as f:
            json.dump(obj, f)
        return obj


def validate_chrome_trace(obj: dict) -> dict:
    """Validate a trace object against the Chrome trace-event schema.

    Checks the subset Perfetto needs to load the file: the
    ``traceEvents`` array, per-phase required keys, non-negative
    timestamps/durations.  Raises :class:`ValueError` on the first
    violation; returns ``{"events": n, "by_phase": {...}}`` on success.
    """
    if not isinstance(obj, dict) or not isinstance(obj.get("traceEvents"), list):
        raise ValueError("trace must be an object with a traceEvents array")
    by_phase: dict[str, int] = {}
    required = {
        "X": ("name", "ts", "dur", "pid", "tid"),
        "i": ("name", "ts", "s"),
        "C": ("name", "ts", "args"),
        "M": ("name", "args"),
    }
    for i, ev in enumerate(obj["traceEvents"]):
        if not isinstance(ev, dict) or "ph" not in ev:
            raise ValueError(f"traceEvents[{i}]: not an event object")
        ph = ev["ph"]
        if ph not in required:
            raise ValueError(f"traceEvents[{i}]: unknown phase {ph!r}")
        for key in required[ph]:
            if key not in ev:
                raise ValueError(f"traceEvents[{i}] (ph={ph}): missing {key!r}")
        if "ts" in ev and not ev["ts"] >= 0:
            raise ValueError(f"traceEvents[{i}]: negative ts {ev['ts']}")
        if ph == "X" and not ev["dur"] >= 0:
            raise ValueError(f"traceEvents[{i}]: negative dur {ev['dur']}")
        by_phase[ph] = by_phase.get(ph, 0) + 1
    return {"events": len(obj["traceEvents"]), "by_phase": by_phase}
