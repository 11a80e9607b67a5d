"""Host time of the ops' kernel launches a group, in ms: the program's
spans ``prof.ops.launch`` (``kernels/sojourn_eval/ops.py``, ``dynamic.py``)
around each kernel wrapper's call: its checks, the library's lookup, the
tables made on the card, the allocations and the ctypes call, as a mean
over the window's groups (``harness/program_spans.py``).  They lie inside
the op spans of ``op_host_ms``.  Nothing to read when the program recorded
no such span."""

from portbench.harness import program_spans


def read(window):
    s = program_spans.seconds(window, "prof.ops.launch.")
    return None if s is None else s / window.n_groups * 1e3
