"""Host time of the workload cache's keys a group, in ms: the program's
probe ``prof.cache.key`` (``core/policies.py``, ``workload_cached``), the
digest of the whole group hashed on every lookup, as a mean over the
window's groups (``harness/program_spans.py``).  It lies inside the plan
spans of ``plan_host_ms``.  Nothing to read when the program recorded no
such probe."""

from portbench.harness import program_spans


def read(window):
    s = program_spans.seconds(window, "prof.cache.key.")
    return None if s is None else s / window.n_groups * 1e3
