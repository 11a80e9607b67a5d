"""The readers of the program's spans and counters that ``Window`` does not
carry (``harness/program_spans.py``): each gives its mean a group from the
program's registry, and nothing when the registry holds what was recorded
outside the window, when there is no device trace, or when the program
records no such name."""

import numpy as np
import pytest
from portbench_testkit import REPO

from portbench.harness import manifest
from portbench.harness.session import Window
from portbench.harness.trace import Trace

N_GROUPS = 4
#: What the program recorded over the window: span seconds by name.
SPANS = {
    "sojourn_eval.static.enum.cuda": [0.5, 0.25],
    "sojourn_eval.dynamic.enum.cuda": [1.0],
    "entry.plan.group": [0.01, 0.02],
    "entry.plan.static": [0.03],
    "entry.plan.sr": [0.2],
    "ops.args": [0.04, 0.06],
    "ops.launch": [0.1],
}
KEYS = [0.004] * 6  # six cache lookups
H2D = 4000
WANT = {
    "plan_host_ms": (0.01 + 0.02 + 0.03 + 0.2) / N_GROUPS * 1e3,
    "cache_key_ms": sum(KEYS) / N_GROUPS * 1e3,
    "cache_lookups_per_group": len(KEYS) / N_GROUPS,
    "args_host_ms": (0.04 + 0.06) / N_GROUPS * 1e3,
    "launch_host_ms": 0.1 / N_GROUPS * 1e3,
    "h2d_bytes_per_group": H2D / N_GROUPS,
}


@pytest.fixture
def registry(monkeypatch):
    from repro_torch.obs import metrics

    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_DEFAULT", reg)
    return reg


def _record(reg, spans=SPANS, keys=KEYS, h2d=H2D):
    for name, values in spans.items():
        for v in values:
            reg.histogram(f"prof.{name}.seconds").observe(v)
            reg.counter(f"prof.{name}.calls").inc()
    for v in keys:
        reg.histogram("prof.cache.key.seconds").observe(v)
        reg.counter("prof.cache.key.calls").inc()
        reg.histogram("prof.cache.mem_hit.seconds").observe(2 * v)  # holds the key: not read
    if h2d:
        reg.counter("prof.ops.h2d_bytes").inc(h2d)


def _window(reg, trace=True) -> Window:
    """The window as the session builds it: ``spans_s`` the registry's
    op spans."""
    hist = reg.snapshot()["histograms"]
    spans = {k: h["sum"] for k, h in hist.items()
             if k.startswith("prof.sojourn_eval.") and k.endswith(".seconds")}
    return Window(N_GROUPS, np.full(N_GROUPS, 1.0), 5.0, spans, {"sojourn_enum": 8},
                  Trace([], [], 0.0, []) if trace else None, None, [])


def _readers():
    cell = manifest.load(REPO).cell("m2-exact-n26")
    return {name: cell.reader(name) for name in WANT}


def test_each_reader_gives_its_mean_a_group(registry):
    _record(registry)
    win = _window(registry)
    for name, reader in _readers().items():
        assert reader.read(win) == pytest.approx(WANT[name], rel=1e-12), name


def test_nothing_to_read_past_the_window_off_the_card_or_in_another_tree(registry):
    _record(registry)
    win = _window(registry)
    off_card = _window(registry, trace=False)
    registry.histogram("prof.sojourn_eval.static.enum.cuda.seconds").observe(0.3)  # outside
    for name, reader in _readers().items():
        assert reader.read(win) is None, name
        assert reader.read(off_card) is None, name


def test_nothing_to_read_from_a_program_without_the_names(registry):
    _record(registry, {k: v for k, v in SPANS.items() if k.startswith("sojourn_eval.")},
            keys=[], h2d=0)
    win = _window(registry)
    for name, reader in _readers().items():
        assert reader.read(win) is None, name
    cell = manifest.load(REPO).cell("m2-exact-n26")
    assert cell.reader("evaluator_self_ms").read(win) == pytest.approx((4.0 - 1.75) / 4 * 1e3)
