"""Hook protocol for the unified discrete-event engine.

The engine (:mod:`repro_torch.core.des.engine`) owns the event heap, the
same-instant batch draining, the ready queue and the server pool; all
*policy* — which job goes first, how long a stage takes, what happens on
a node failure — is delegated to a :class:`SchedulerHooks` instance.
``core/simulator.py`` lowers onto it with pure table lookups;
``cluster/manager.py`` adds fault injection, straggler duplicate-and-race
and real-runner callbacks.  Both therefore share one contention
semantics, the one the fused lockstep evaluators replicate.

Observers are a separate surface: the engine emits typed, batched trace
records (:mod:`repro_torch.core.des.events`) to
:class:`~repro_torch.core.des.events.EngineObserver` instances — hooks decide
*behavior*, observers only *watch*.
"""

from __future__ import annotations

__all__ = ["SchedulerHooks"]


class SchedulerHooks:
    """Behavioral callbacks the engine invokes.  Subclass per frontend.

    Required overrides: :meth:`index`, :meth:`stage_duration`,
    :meth:`outcome`.  The rest default to no-ops.
    """

    # -- required ---------------------------------------------------------

    def index(self, job: int, stage: int) -> float:
        """Policy index of ``job`` about to serve ``stage`` (min first)."""
        raise NotImplementedError

    def stage_duration(self, job: int, stage: int, now: float) -> float:
        """Wall-clock duration of ``stage`` of ``job`` dispatched at ``now``.

        Called exactly once per dispatch, in dispatch order — stateful
        implementations (EWMA straggler detection, real runners) rely on
        that ordering.
        """
        raise NotImplementedError

    def outcome(self, job: int) -> int:
        """Realized stop stage of ``job`` (0-based).

        Read at stage-*completion* time, so implementations may revise it
        while the stage is in flight (e.g. a real runner's metric gate
        terminating the job early).
        """
        raise NotImplementedError

    # -- optional ---------------------------------------------------------

    def is_success(self, job: int) -> bool:
        """Whether ``job``'s realized outcome is a *success* (vs an early
        termination).  Classifies the exit trace record as ``complete``
        or ``cancel``; frontends that know the job's stage count override
        this with ``outcome(job) == num_stages - 1``.
        """
        return True

    def on_complete(self, job: int, now: float) -> None:
        """``job`` left the system at ``now`` (success or termination)."""

    def on_failure(self, engine, now: float) -> None:
        """A ``FAILURE`` event fired at ``now``.

        The hook owns the whole failure semantics: typically abort a
        running job via ``engine.abort(job)``, schedule its re-arrival,
        and re-arm the failure timer via ``engine.schedule``.  Engines
        without faults never schedule ``FAILURE`` events, so the default
        is a no-op.
        """
