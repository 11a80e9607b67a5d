"""Unified discrete-event scheduling engine: the port's ``repro/core/des``.

Host code (NumPy and ``heapq``), as in the reference; docs/des_engine.md
describes the design both packages share.
"""

from repro_torch.core.des.engine import (  # noqa: F401
    ARRIVAL,
    FAILURE,
    RESIZE,
    STAGE_DONE,
    Engine,
    ReadyQueue,
    ServerPool,
)
from repro_torch.core.des.events import (  # noqa: F401
    EVENT_NAMES,
    EngineObserver,
    TraceEvent,
)
from repro_torch.core.des.hooks import SchedulerHooks  # noqa: F401
