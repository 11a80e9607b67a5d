"""Kernel launches a group: the program's ``launches`` counters of
``kernels/sojourn_eval/kernel.py`` and ``dynamic.py`` over the window,
over its groups.  Nothing to read when the program counted none."""


def read(window):
    total = sum(window.launches.values())
    if not total or not window.n_groups:
        return None
    return total / window.n_groups
