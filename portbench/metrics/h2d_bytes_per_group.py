"""Bytes of kernel inputs built on the host and moved to the card a group:
the program's counter ``prof.ops.h2d_bytes`` (``kernels/sojourn_eval/ops.py``,
``dynamic.py``) over the window's groups (``harness/program_spans.py``).
Nothing to read when the program counted none."""

from portbench.harness import program_spans


def read(window):
    n = program_spans.counter(window, "prof.ops.h2d_bytes")
    return None if n is None else n / window.n_groups
