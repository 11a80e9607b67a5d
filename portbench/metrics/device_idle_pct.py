"""The card's idle share of the traced window, in %: one minus the union
of its kernel, copy and set intervals over the window."""


def read(window):
    if window.trace is None or not window.trace.intervals:
        return None
    return 100.0 * (1.0 - window.trace.busy_s / window.window_s)
