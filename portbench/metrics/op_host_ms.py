"""Host time of the ops layer (``kernels/sojourn_eval/ops.py``,
``dynamic.py``) a group, in ms: the program's static and dynamic spans,
which end with the results copied to the host and so wait for the card,
minus the device's busy time in the traced window (every kernel and copy
runs inside those spans), as a mean over the window's groups."""


def read(window):
    spans = sum(window.spans_s.values())
    if window.trace is None or not spans or not window.n_groups:
        return None
    return (spans - window.trace.busy_s) / window.n_groups * 1e3
