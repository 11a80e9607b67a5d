"""Host time of the entry layer's plan a group, in ms: every program span
``prof.entry.plan.*`` (``core/evaluator.py``): the group's combination
count and Monte-Carlo seed, each policy's order or index table and the
padded arrays its op is given, all the host work before each op call, as a
mean over the window's groups (``harness/program_spans.py``).  Nothing to
read when the program recorded no such span."""

from portbench.harness import program_spans


def read(window):
    s = program_spans.seconds(window, "prof.entry.plan.")
    return None if s is None else s / window.n_groups * 1e3
