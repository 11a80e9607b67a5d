"""The traced run's reduction of a ``torch.profiler`` trace.

The profiler runs over exactly the measured window, with CPU and CUDA
activities.  From its events this module keeps the device's kernels,
copies and sets (their intervals and names) and the host's operations,
and gives the per-layer readers:

* :meth:`Trace.kernel_seconds`: the device time of the kernels whose name
  matches a pattern, each with the ``reduce_partials`` launch that follows
  it on the card (the second half of every sojourn kernel's call);
* ``busy_s``: the union of every device interval;
* :meth:`Trace.breakdown`: the ten device operations that took most time,
  and the idle gaps of the device summed by what the host was doing: the
  host operation that overlaps a gap most, else the operations it lies
  between.
"""

from __future__ import annotations

import bisect
import dataclasses
import gzip
import json
import math
import re

__all__ = ["Trace", "from_profiler"]

#: The launch that folds a sojourn kernel's per-block partials (common.cuh).
TAIL = re.compile(r"\breduce_partials\b")


@dataclasses.dataclass
class Trace:
    device: list[tuple[str, float, float]]  # (name, start s, end s), by start
    host: list[tuple[str, float, float]]  # top-level host operations, by start
    busy_s: float
    intervals: list[tuple[float, float]]  # the union of the device intervals

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        total, owner = 0.0, False
        for name, t0, t1 in self.device:
            if rx.search(name):
                total, owner = total + (t1 - t0), True
            elif owner and TAIL.search(name):
                total, owner = total + (t1 - t0), False
            elif not name.startswith("Memcpy") and not name.startswith("Memset"):
                owner = False
        return total

    def device_ops(self, top: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for name, t0, t1 in self.device:
            by[name] = by.get(name, 0.0) + (t1 - t0)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, window: tuple[float, float], top: int = 10) -> list[list]:
        edges = [window[0], *[t for iv in self.intervals for t in iv], window[1]]
        starts = [h[1] for h in self.host]
        by: dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            label = self._label(a, b, starts)
            by[label] = by.get(label, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def _label(self, a: float, b: float, starts: list[float]) -> str:
        i = bisect.bisect_left(starts, b)
        near = self.host[max(0, i - 64):i]
        best, best_overlap = None, 0.0
        for name, t0, t1 in near:
            overlap = min(b, t1) - max(a, t0)
            if overlap > best_overlap:
                best, best_overlap = name, overlap
        if best is not None and best_overlap >= 0.5 * (b - a):
            return f"host in {best}"
        before = next((h[0] for h in reversed(near) if h[2] <= a), "the window's start")
        after = self.host[i][0] if i < len(self.host) else "the window's end"
        return f"host between {before} and {after}"

    def breakdown(self, window: tuple[float, float]) -> dict:
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_gaps(window)}

    def write_chrome(self, path) -> None:
        """The device's operations and the host's top-level ones as a gzipped
        Chrome trace (``chrome://tracing``, Perfetto): some MB where the
        profiler's own export of a 20 s window takes hundreds."""
        events = [{"name": name, "ph": "X", "pid": 0, "tid": tid, "ts": round(t0 * 1e6, 3),
                   "dur": round((t1 - t0) * 1e6, 3)}
                  for tid, rows in (("device", self.device), ("host", self.host))
                  for name, t0, t1 in rows]
        with gzip.open(path, "wt", compresslevel=1) as f:
            json.dump({"traceEvents": events}, f)


def _union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for t0, t1 in sorted(spans):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def _raw_events(prof):
    """``(name, on_device, start s, end s, thread)`` of every event of a
    stopped ``torch.profiler.profile``, read from its raw results: the
    profiler's own ``events()`` builds a Python tree of every host operation,
    minutes for a window of a million of them."""
    from torch import _C
    from torch.autograd import DeviceType

    raw = [e for e in prof.profiler.kineto_results.events() if not e.is_hidden_event()]
    base = min((e.start_ns() for e in raw), default=0)  # in integers: ns since 1970 fill a double
    out = []
    for e in raw:
        t0 = e.start_ns() - base
        out.append((_C._demangle(e.name()), e.device_type() != DeviceType.CPU, t0 * 1e-9,
                    (t0 + e.duration_ns()) * 1e-9, e.start_thread_id()))
    return out


def from_events(events, marker: str) -> tuple[Trace, tuple[float, float]]:
    """The trace of ``events`` as :func:`_raw_events` gives them and the
    window, the span of the host event named ``marker``; device intervals
    clipped to the window.  The host operations are the outermost of their
    thread: those that no other host event of the thread holds, but the
    marker."""
    marks = [e for e in events if e[0] == marker and not e[1]]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} spans named {marker!r}, not one")
    window = (marks[0][2], marks[0][3])
    device, host, ends = [], [], {}
    for name, on_device, t0, t1, tid in sorted(events, key=lambda e: (e[2], -e[3])):
        if on_device:
            t0, t1 = max(t0, window[0]), min(t1, window[1])
            if t1 > t0 and name != marker:  # not the marker's own range on the card
                device.append((name, t0, t1))
        elif (name, t0, t1) != marks[0][:1] + marks[0][2:4] and t0 >= ends.get(tid, -math.inf):
            host.append((name, t0, t1))
            ends[tid] = t1
    intervals = _union([(t0, t1) for _, t0, t1 in device])
    return Trace(device, host, sum(b - a for a, b in intervals), intervals), window


def from_profiler(prof, marker: str) -> tuple[Trace, tuple[float, float]]:
    """The trace of a stopped ``torch.profiler.profile`` (see
    :func:`from_events`)."""
    return from_events(_raw_events(prof), marker)
