"""Service positions a ``sojourn_enum`` thread walks after its prefix, a
launch: the program's counter ``prof.ops.enum_suffix``
(``kernels/sojourn_eval/kernel.py``, the L that ``suffix_length`` chose,
added at every launch) over the window's ``sojourn_enum`` launches
(``harness/program_spans.py``).  Nothing to read when the program counted
none."""

from portbench.harness import program_spans


def read(window):
    n = program_spans.counter(window, "prof.ops.enum_suffix")
    launches = window.launches.get("sojourn_enum", 0)
    return None if n is None or not launches else n / launches
