"""The whole evaluation's share of the card's peak, in %: the sum over the
window's groups of each group's least time on the card (every kernel's
float64 operations and bytes, and the Threefry stream once, since every
policy shares it) over the window's wall time.  Nothing to read off the
card."""


def read(window):
    if window.peaks is None or not window.work:
        return None
    least = 0.0
    for group in window.work:
        least += window.peaks.least_seconds(
            sum(w["flops"] for w in group.values()), sum(w["bytes"] for w in group.values()),
            max(w["stream"] for w in group.values()))
    return 100.0 * least / window.window_s
