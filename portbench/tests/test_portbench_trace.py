"""The traced run's reduction: the outermost host operations and the
device's busy time from the profiler's raw events, as the profiler's own
tree of events gives them."""

import numpy as np
import pytest
import torch
from portbench_testkit import REPO  # noqa: F401  (puts the repo on the path)

from portbench.harness import trace


def test_outermost_host_events_and_clipped_device_intervals():
    events = [
        ("window", False, 1.0, 9.0, 1),
        ("before", False, 0.0, 0.5, 1),
        ("op_a", False, 1.0, 3.0, 1), ("op_a.child", False, 1.5, 2.0, 1),
        ("op_b", False, 4.0, 5.0, 1), ("op_b.child", False, 4.0, 4.5, 1),
        ("other_thread", False, 1.2, 1.4, 2),
        ("kernel", True, 0.5, 2.0, 0), ("copy", True, 1.8, 2.5, 0), ("late", True, 8.5, 9.5, 0),
        ("window", True, 1.0, 9.0, 0),
    ]
    tr, window = trace.from_events(events, "window")
    assert window == (1.0, 9.0)
    assert [h[0] for h in tr.host] == ["before", "op_a", "other_thread", "op_b"]
    assert [d[0] for d in tr.device] == ["kernel", "copy", "late"]
    assert tr.intervals == [(1.0, 2.5), (8.5, 9.0)]
    assert tr.busy_s == pytest.approx(2.0)
    with pytest.raises(RuntimeError):
        trace.from_events(events[1:], "window")


def test_raw_events_give_the_profilers_own_outermost_operations():
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with torch.profiler.record_function("window"):
        for _ in range(20):
            x = torch.as_tensor(np.arange(64.0)).reshape(8, 8)
            (x @ x).sum().item()
    prof.stop()
    tr, _ = trace.from_profiler(prof, "window")
    events = prof.events()
    (mark,) = [e for e in events if e.name == "window"]
    want = [e.name for e in sorted(events, key=lambda e: e.time_range.start)
            if e is not mark and (e.cpu_parent is None or e.cpu_parent is mark)]
    assert [h[0] for h in tr.host] == want
