"""Typed observer events for the unified discrete-event engine.

The engine (:mod:`repro_torch.core.des.engine`) emits one *trace record* per
semantic scheduling action — arrival, dispatch, stage completion,
success/cancel exit, failure, restart (failure abort), resize.  Records
are flat tuples appended to an internal buffer and handed to observers
in **batches** (:class:`EngineObserver.on_events`), so million-event
replays pay one Python observer call per ``batch_size`` events instead
of per event.  :class:`TraceEvent` is the typed view of one record;
consumers that want structure (tests, exporters) decode on demand while
the hot path stays tuple-append cheap.

Every record carries a post-event snapshot of the scheduler state
(ready-queue length, busy/free server counts, resize target), so
batched consumers can check invariants and derive queue-depth /
utilization time series without touching live engine state.

The legacy observer form — a bare callable ``observer(engine, now)``
invoked per event — still works through :class:`LegacyObserverShim`
but raises a :class:`DeprecationWarning`; port call sites to
:class:`EngineObserver` (e.g. :class:`repro_torch.obs.TraceRecorder`).
"""

from __future__ import annotations

import dataclasses
import warnings

__all__ = [
    "EV_ARRIVAL",
    "EV_DISPATCH",
    "EV_STAGE_DONE",
    "EV_COMPLETE",
    "EV_CANCEL",
    "EV_FAILURE",
    "EV_RESTART",
    "EV_RESIZE",
    "EVENT_NAMES",
    "TraceEvent",
    "EngineObserver",
    "LegacyObserverShim",
    "normalize_observers",
]

#: Trace-record kinds (richer than the engine's event-heap kinds: one
#: heap event can produce several trace records, e.g. a FAILURE heap
#: event emits EV_FAILURE plus an EV_RESTART for the aborted job).
(
    EV_ARRIVAL,
    EV_DISPATCH,
    EV_STAGE_DONE,
    EV_COMPLETE,
    EV_CANCEL,
    EV_FAILURE,
    EV_RESTART,
    EV_RESIZE,
) = range(8)

EVENT_NAMES = (
    "arrival",
    "dispatch",
    "stage_done",
    "complete",
    "cancel",
    "failure",
    "restart",
    "resize",
)

#: Field order of the flat record tuples the engine emits.
RECORD_FIELDS = (
    "time",
    "kind",
    "job",
    "stage",
    "value",
    "queue_len",
    "busy",
    "free",
    "target",
)


@dataclasses.dataclass(frozen=True, slots=True)
class TraceEvent:
    """Typed view of one engine trace record.

    ``job``/``stage`` are ``-1`` where not applicable (failure, resize).
    ``value`` is kind-specific: stage duration for ``dispatch``, abort
    span for ``restart``, new server target for ``resize``, else 0.
    ``queue_len``/``busy``/``free``/``target`` snapshot the scheduler
    state immediately *after* the event.
    """

    time: float
    kind: int
    job: int
    stage: int
    value: float
    queue_len: int
    busy: int
    free: int
    target: int

    @property
    def name(self) -> str:
        return EVENT_NAMES[self.kind]

    @classmethod
    def from_record(cls, record: tuple) -> "TraceEvent":
        return cls(*record)

    def as_record(self) -> tuple:
        return dataclasses.astuple(self)


class EngineObserver:
    """Batched observer protocol; subclass and override what you need.

    The engine buffers trace records and calls :meth:`on_events` with
    the buffered batch every ``batch_size`` records and once more at
    the end of the run, followed by :meth:`on_run_end`.  The records
    list is owned by the engine's flush — copy (or ``extend`` into your
    own storage) rather than holding a reference.
    """

    #: Records buffered between observer calls; the engine uses the
    #: minimum across its attached observers.
    batch_size: int = 4096

    def on_events(self, engine, records: list[tuple]) -> None:
        """A batch of flat trace records (see ``RECORD_FIELDS``)."""

    def on_run_end(self, engine) -> None:
        """The engine's event heap drained; the run is complete."""


class LegacyObserverShim:
    """Adapter for the deprecated ``observer(engine, now)`` callable form.

    The engine invokes legacy callables per event (never batched) so
    their historical contract — inspect live engine state after every
    handled event — keeps holding.
    """

    def __init__(self, fn):
        warnings.warn(
            "bare-callable engine observers (observer(engine, now)) are "
            "deprecated; subclass repro_torch.core.des.events.EngineObserver "
            "(e.g. use repro_torch.obs.TraceRecorder) for batched typed events",
            DeprecationWarning,
            stacklevel=3,
        )
        self.fn = fn

    def __call__(self, engine, now: float) -> None:
        self.fn(engine, now)


def normalize_observers(observer):
    """Split an observer spec into (legacy callables, batched observers).

    ``observer`` may be ``None``, a single observer, or a list/tuple
    mixing both styles; ``None`` entries are dropped.  Bare callables
    (anything without an ``on_events`` method) go through
    :class:`LegacyObserverShim` with a deprecation warning.
    """
    if observer is None:
        items = []
    elif isinstance(observer, (list, tuple)):
        items = [o for o in observer if o is not None]
    else:
        items = [observer]
    legacy, batched = [], []
    for o in items:
        if hasattr(o, "on_events"):
            batched.append(o)
        else:
            legacy.append(LegacyObserverShim(o))
    return legacy, batched
