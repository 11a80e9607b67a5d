"""Ranked (job, stage) entries of a dynamic kernel's queue, a launch: the
program's counter ``prof.ops.dynamic_entries`` (``kernels/sojourn_eval/
dynamic.py``, N M added at every ``dynamic_sojourn_enum`` and
``dynamic_sojourn_mc`` launch) over the window's launches of the two
(``harness/program_spans.py``).  N M sets the queue's mask words, and so
the kernel's register path against its memory path.  Nothing to read when
the program counted none."""

from portbench.harness import program_spans

KERNELS = ("dynamic_sojourn_enum", "dynamic_sojourn_mc")


def read(window):
    n = program_spans.counter(window, "prof.ops.dynamic_entries")
    launches = sum(window.launches.get(k, 0) for k in KERNELS)
    return None if n is None or not launches else n / launches
