"""Unified discrete-event engine for the online multi-server setting.

One event loop serves both frontends (paper §V–VI):

* :func:`repro_torch.core.simulator.simulate` — the trace-study DES;
* :class:`repro_torch.cluster.manager.ClusterManager` — faults, stragglers,
  elastic resize, real training jobs.

Semantics (the ones the fused lockstep evaluators in
:mod:`repro_torch.kernels.sojourn_eval` replicate exactly):

* **Same-instant batch draining.**  All events with equal timestamps are
  drained as one batch *before* any dispatch, so simultaneous arrivals
  (the paper's static setting: all jobs present at t=0) contend by
  policy index rather than by event order; ties break by job position.
* **Stage-boundary preemption.**  A job that completes a stage and
  stays alive releases its server and re-competes with the whole ready
  queue at its updated conditional index (not just the queue head).
* **Drain-aware server pool.**  Elastic shrink retires servers at stage
  boundaries; every release path (stage completion *and* failure abort)
  checks the target, so ``len(running) + free <= target`` holds at every
  event and no server is leaked or double-freed.

Observability: the engine emits one flat trace record per scheduling
action (see :mod:`repro_torch.core.des.events`) to attached
:class:`~repro_torch.core.des.events.EngineObserver` instances, buffered and
dispatched in batches so tracing a million-event replay costs one
observer call per ``batch_size`` records.  With no observer attached,
no records are built.  Always-on aggregates (per-job service time,
aborted-work time, the time integral of the server target) are cheap
scalar updates and feed the metrics layer in :mod:`repro_torch.obs`.

The port's counterpart of ``repro/core/des/engine.py``, held to it bit
for bit (``SimResult`` fields, trace-record streams), so it keeps the
reference's data structures: ``heapq`` on ``(t, seq, kind, payload)``
with an ``itertools.count`` tie-break, float64 NumPy arrays for
``stage``, ``completion`` and ``service_time``.  It is host code by
design: one event at a time, a tensor op would cost far more than a
heap push, and no device work happens here.

One semantic gap to the fused kernels (ROADMAP fault R2): a queued job
whose index is ``+inf`` is served last here, after every finite-index
job, while the fused dynamic kernels never seat it.  This engine keeps
the DES semantics, because it is held to ``repro``'s DES; the fused
evaluators keep theirs.
"""

from __future__ import annotations

import heapq
import itertools

import numpy as np

from repro_torch.core.des.events import (
    EV_ARRIVAL,
    EV_CANCEL,
    EV_COMPLETE,
    EV_DISPATCH,
    EV_FAILURE,
    EV_RESIZE,
    EV_RESTART,
    EV_STAGE_DONE,
    normalize_observers,
)
from repro_torch.core.des.hooks import SchedulerHooks

__all__ = [
    "ARRIVAL",
    "STAGE_DONE",
    "FAILURE",
    "RESIZE",
    "ReadyQueue",
    "ServerPool",
    "Engine",
]

# Event kinds.  ARRIVAL / re-arrival payload: job id.  STAGE_DONE payload:
# (job, epoch).  FAILURE payload: ignored.  RESIZE payload: new target.
ARRIVAL, STAGE_DONE, FAILURE, RESIZE = 0, 1, 2, 3


class ReadyQueue:
    """Priority queue of waiting jobs keyed by policy index (min first).

    Queued jobs never change stage, so indices never go stale; O(log N)
    push/pop as noted in the paper's Section V.  Ties break by insertion
    order, i.e. by job position for same-batch arrivals.
    """

    def __init__(self):
        self._heap: list[tuple[float, int, int]] = []
        self._seq = itertools.count()

    def push(self, index: float, job: int) -> None:
        heapq.heappush(self._heap, (index, next(self._seq), job))

    def pop(self) -> int:
        return heapq.heappop(self._heap)[2]

    def peek_index(self) -> float:
        return self._heap[0][0] if self._heap else np.inf

    def __len__(self) -> int:
        return len(self._heap)


class ServerPool:
    """W homogeneous servers with elastic resize and drain-at-boundary.

    ``len(running) + free <= target`` is an invariant at every event:
    grow adds free servers immediately; shrink retires idle servers
    immediately and busy ones as they release (stage completion or
    failure abort).
    """

    def __init__(self, n_servers: int):
        self.free = n_servers
        self.target = n_servers
        self.running: dict[int, int] = {}  # job -> dispatch epoch
        self._epoch = itertools.count()

    @property
    def busy(self) -> int:
        return len(self.running)

    def acquire(self, job: int) -> int:
        """Seize a free server for ``job``; returns the dispatch epoch."""
        if self.free <= 0:
            raise RuntimeError("acquire with no free server")
        if job in self.running:
            raise RuntimeError(f"job {job} dispatched twice")
        self.free -= 1
        ep = next(self._epoch)
        self.running[job] = ep
        return ep

    def release(self, job: int) -> None:
        """Return ``job``'s server; retire it instead if over target."""
        del self.running[job]
        if len(self.running) + self.free + 1 > self.target:
            return  # drain: shrink retires this server at the boundary
        self.free += 1

    def resize(self, target: int) -> None:
        self.target = target
        have = self.free + len(self.running)
        if target > have:
            self.free += target - have
        elif have > target:
            # retire idle servers now; busy ones drain on release
            self.free -= min(self.free, have - target)


class Engine:
    """Event heap + batch draining + dispatch; behavior via hooks.

    The caller seeds the heap with :meth:`schedule` (arrivals, resize
    events, the first failure timer) and calls :meth:`run`.  Per-job
    progress lives in ``stage`` (stages completed so far) and
    ``completion`` (exit time, NaN while in system).

    ``observer`` may be ``None``, an
    :class:`~repro_torch.core.des.events.EngineObserver` (batched typed trace
    records), a deprecated bare callable ``observer(engine, now)``, or
    a list mixing both.
    """

    def __init__(
        self,
        n_jobs: int,
        n_servers: int,
        hooks: SchedulerHooks,
        observer=None,
    ):
        self.n_jobs = n_jobs
        self.hooks = hooks
        self.pool = ServerPool(n_servers)
        self.ready = ReadyQueue()
        self.stage = np.zeros(n_jobs, dtype=np.int64)
        self.completion = np.full(n_jobs, np.nan)
        self.n_done = 0
        self.makespan = 0.0
        self.now = 0.0
        # always-on aggregates for the metrics layer (cheap scalar math)
        self.service_time = np.zeros(n_jobs)  # completed-stage busy time
        self.aborted_time = 0.0  # busy time thrown away by failure aborts
        self._dispatch_time: dict[int, float] = {}
        self._target_integral = 0.0  # ∫ target dt over [0, makespan]
        self._t_target = 0.0
        self._events: list[tuple[float, int, int, object]] = []
        self._seq = itertools.count()
        self._legacy, self._observers = normalize_observers(observer)
        self._emit = bool(self._observers)
        self._batch = (
            min(max(1, int(o.batch_size)) for o in self._observers)
            if self._observers
            else 0
        )
        self._buf: list[tuple] = []

    # -- caller API -------------------------------------------------------

    def schedule(self, t: float, kind: int, payload: object = None) -> None:
        heapq.heappush(self._events, (float(t), next(self._seq), kind, payload))

    def abort(self, job: int) -> None:
        """Abort ``job``'s in-flight stage (failure): free its server.

        Progress is not advanced; the pending ``STAGE_DONE`` goes stale
        via the epoch check.  The hook re-schedules the job's
        re-``ARRIVAL`` itself (e.g. after a checkpoint-restore window).
        """
        span = self.now - self._dispatch_time.pop(job)
        self.aborted_time += span
        self.pool.release(job)
        if self._emit:
            self._record(self.now, EV_RESTART, job, int(self.stage[job]), span)

    def run(self) -> None:
        events = self._events
        while events:
            now, _, kind, payload = heapq.heappop(events)
            self.now = now
            # An armed-but-idle failure timer is not work; everything
            # else (including a stale STAGE_DONE) extends the makespan.
            if kind != FAILURE:
                self.makespan = max(self.makespan, now)
            batch = [(kind, payload)]
            while events and events[0][0] == now:
                _, _, k2, p2 = heapq.heappop(events)
                if k2 != FAILURE:
                    self.makespan = max(self.makespan, now)
                batch.append((k2, p2))
            for kind, payload in batch:
                self._handle(kind, payload, now)
                for fn in self._legacy:
                    fn(self, now)
            while self.pool.free > 0 and len(self.ready):
                self._start(self.ready.pop(), now)
            for fn in self._legacy:
                fn(self, now)
        # close the server-target time integral at the makespan
        self._target_integral += self.pool.target * (self.makespan - self._t_target)
        self._t_target = self.makespan
        if self._emit:
            self._flush()
            for o in self._observers:
                o.on_run_end(self)

    @property
    def busy_time(self) -> float:
        """Total server-busy time (completed stages + aborted work)."""
        return float(self.service_time.sum()) + self.aborted_time

    @property
    def target_integral(self) -> float:
        """∫ server-target dt over the run (denominator of utilization)."""
        return self._target_integral

    # -- internals --------------------------------------------------------

    def _record(self, t: float, kind: int, job: int, stage: int, value: float):
        pool = self.pool
        self._buf.append(
            (t, kind, job, stage, value,
             len(self.ready), len(pool.running), pool.free, pool.target)
        )
        if len(self._buf) >= self._batch:
            self._flush()

    def _flush(self) -> None:
        buf = self._buf
        if not buf:
            return
        self._buf = []
        for o in self._observers:
            o.on_events(self, buf)

    def _handle(self, kind: int, payload: object, now: float) -> None:
        if kind == ARRIVAL:
            job = payload
            stage = int(self.stage[job])
            self.ready.push(self.hooks.index(job, stage), job)
            if self._emit:
                self._record(now, EV_ARRIVAL, job, stage, 0.0)
        elif kind == STAGE_DONE:
            job, epoch = payload
            if self.pool.running.get(job) != epoch:
                return  # stale: the job was aborted and re-dispatched
            self.service_time[job] += now - self._dispatch_time.pop(job)
            self.pool.release(job)
            done_stage = int(self.stage[job])
            self.stage[job] += 1
            if done_stage == self.hooks.outcome(job):
                self.completion[job] = now
                self.n_done += 1
                self.hooks.on_complete(job, now)
                if self._emit:
                    ev = EV_COMPLETE if self.hooks.is_success(job) else EV_CANCEL
                    self._record(now, ev, job, done_stage, 0.0)
            else:  # alive: re-compete with the whole queue (paper §V)
                self.ready.push(self.hooks.index(job, done_stage + 1), job)
                if self._emit:
                    self._record(now, EV_STAGE_DONE, job, done_stage, 0.0)
        elif kind == RESIZE:
            self._target_integral += self.pool.target * (now - self._t_target)
            self._t_target = now
            self.pool.resize(payload)
            if self._emit:
                self._record(now, EV_RESIZE, -1, -1, float(payload))
        elif kind == FAILURE:
            if self._emit:
                self._record(now, EV_FAILURE, -1, -1, 0.0)
            self.hooks.on_failure(self, now)
        else:
            raise ValueError(f"unknown event kind {kind}")

    def _start(self, job: int, now: float) -> None:
        epoch = self.pool.acquire(job)
        stage = int(self.stage[job])
        dur = self.hooks.stage_duration(job, stage, now)
        self._dispatch_time[job] = now
        self.schedule(now + dur, STAGE_DONE, (job, epoch))
        if self._emit:
            self._record(now, EV_DISPATCH, job, stage, dur)
