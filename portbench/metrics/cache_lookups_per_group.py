"""Workload-cache lookups a group: the program's ``prof.cache.key.calls``
counter (``core/policies.py``, ``workload_cached``, one a lookup, hit or
miss) over the window's groups (``harness/program_spans.py``).  Nothing
to read when the program counted none."""

from portbench.harness import program_spans


def read(window):
    n = program_spans.counter(window, "prof.cache.key.calls")
    return None if n is None else n / window.n_groups
