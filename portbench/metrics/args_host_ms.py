"""Host time of the ops' kernel arguments a group, in ms: the program's
spans ``prof.ops.args`` (``kernels/sojourn_eval/ops.py``, ``dynamic.py``):
the job axis permuted along each order, the host CDF, the tensors built
and moved to the card, as a mean over the window's groups
(``harness/program_spans.py``).  They lie inside the op spans of
``op_host_ms``.  Nothing to read when the program recorded no such span."""

from portbench.harness import program_spans


def read(window):
    s = program_spans.seconds(window, "prof.ops.args.")
    return None if s is None else s / window.n_groups * 1e3
