"""Self time of the entry layer (``core/evaluator.py``, ``core/policies.py``)
a group, in ms: the benchmark's clock around each group minus the
program's own ``prof.sojourn_eval.static.*`` and ``.dynamic.*`` spans
(``obs/profiling.py``), as a mean over the window's groups.  Nothing to
read when the program recorded no such span."""


def read(window):
    spans = sum(window.spans_s.values())
    if not spans or not window.n_groups:
        return None
    return (float(window.latencies_s.sum()) - spans) / window.n_groups * 1e3
