"""The program's spans and counters over the traced window, read from its
metrics registry (``repro_torch.obs.metrics``), for the per-layer readers
of names that :class:`~portbench.harness.session.Window` does not carry
(its ``spans_s`` holds only the ops' ``prof.sojourn_eval.*`` spans).

``session.run`` turns the program's profiling on for the window alone, so
the registry's totals are the window's.  That is checked, not assumed: the
registry's ``prof.sojourn_eval.*.seconds`` total must equal the window's
(``Window.spans_s``, which the session took as differences over the
window); else something was recorded outside the window (``REPRO_PROFILE=1``
set, say) and every reading here is ``None``.  So is every reading off the
card (no device trace): the harness's CPU path is for tests, whose process
shares the registry with the tests before them.  A name the program does
not record (a tree without these spans) reads ``None`` too.
"""

from __future__ import annotations

__all__ = ["seconds", "counter"]

OPS = "prof.sojourn_eval."


def _snapshot(window) -> dict | None:
    """The program's registry, when its totals are the traced window's."""
    if window.trace is None or not window.n_groups:
        return None
    from repro_torch.obs import metrics

    snap = metrics.get_registry().snapshot()
    ops = sum(h.get("sum", 0.0) for name, h in snap["histograms"].items()
              if name.startswith(OPS) and name.endswith(".seconds"))
    if not ops or ops != sum(window.spans_s.values()):
        return None
    return snap


def seconds(window, prefix: str) -> float | None:
    """Seconds of every span ``prof.<name>.seconds`` whose name starts with
    ``prefix``, over the window; ``None`` when it recorded none."""
    snap = _snapshot(window)
    if snap is None:
        return None
    found = [h.get("sum", 0.0) for name, h in snap["histograms"].items()
             if name.startswith(prefix) and name.endswith(".seconds")]
    return sum(found) if found else None


def counter(window, name: str) -> int | None:
    """The counter ``name`` over the window; ``None`` when it was not counted."""
    snap = _snapshot(window)
    if snap is None:
        return None
    return snap["counters"].get(name)
