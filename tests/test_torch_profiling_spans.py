"""The profiling spans inside the evaluator's host path (``obs/profiling.py``).

With profiling on, one ``evaluate_many`` records the plan spans of the
entry layer, the op spans with their ``ops.args`` and ``ops.launch``
spans inside, the cache-key probe and the bytes of the kernel inputs, and
each span is a profiler range on the ``torch.profiler`` timeline: plan and
op spans side by side, the ``ops.*`` spans inside the op spans.  The kernel
wrappers count the regime their shapes put a launch in.  With profiling off
nothing is recorded and no range is opened.  All on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import evaluator as ev
from repro_torch.core import policies
from repro_torch.core.jobs import JobSpec
from repro_torch.kernels.sojourn_eval import dynamic, kernel
from repro_torch.obs import metrics, profiling

REPO = Path(__file__).resolve().parents[1]
ALGS = ("optimal", "rank", "serpt", "sr", "random")
#: The program's own range names, as they reach the profiler's timeline.
PROGRAM = ("entry.", "ops.", "sojourn_eval.", "cache.")
OPS = ("sojourn_eval.static.enum.cpu", "sojourn_eval.dynamic.enum.cpu")


def _group(n=4, m=2):
    """``n`` jobs of ``m`` stages (K = m**n combinations)."""
    rng = np.random.default_rng(11)
    jobs = []
    for i in range(n):
        sizes = np.cumsum(rng.uniform(0.5, 2.0, m))
        probs = rng.dirichlet(np.ones(m))
        jobs.append(JobSpec(sizes=sizes, probs=probs, job_id=i))
    return jobs


@pytest.fixture
def registry(monkeypatch):
    """A fresh default registry, an empty workload cache without its disk
    tier, and profiling switched back as it was afterwards."""
    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_DEFAULT", reg)
    monkeypatch.setattr(profiling, "_ENABLED", profiling.enabled())
    monkeypatch.delenv("REPRO_CACHE_DIR", raising=False)
    policies.clear_workload_cache()
    return reg


def _ranges(prof) -> list[tuple[str, int, int]]:
    """``(name, start ns, end ns)`` of the program's ranges in a stopped
    profiler's trace."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(PROGRAM)]


def _profiled(fn):
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        with torch.profiler.record_function("portbench.window"):
            fn()
    finally:
        prof.stop()
    return prof


def _h2d_bytes(n, m, n_orders) -> int:
    """Bytes ``static_kernel_args`` builds for ``n_orders`` orders of an
    exact group: sizes and probs (N, M) float64, strides and stage counts
    (N,) int32, permuted along each order."""
    return n_orders * (2 * n * m * 8 + 2 * n * 4)


def test_every_span_and_counter_of_a_group(registry):
    jobs = _group()
    n, m = 4, 2
    profiling.enable(True)
    prof = _profiled(lambda: ev.evaluate_many(jobs, ALGS, np.random.default_rng(0),
                                              device="cpu"))
    snap = registry.snapshot()
    hist, counters = snap["histograms"], snap["counters"]
    for name in ("group", "optimal", "rank", "random", "static", "serpt", "sr"):
        assert hist[f"prof.entry.plan.{name}.seconds"]["count"] >= 1, name
    assert hist["prof.entry.plan.static.seconds"]["count"] == 3  # optimal, rank, random
    assert hist["prof.sojourn_eval.static.enum.cpu.seconds"]["count"] == 3
    assert hist["prof.sojourn_eval.dynamic.enum.cpu.seconds"]["count"] == 2
    # one batch of orders a static call, one call a dynamic policy
    assert counters["prof.ops.args.calls"] == counters["prof.ops.launch.calls"] == 5
    lookups = counters["prof.cache.key.calls"]
    assert lookups >= 5 and hist["prof.cache.key.seconds"]["count"] == lookups
    assert counters["prof.cache.mem_hit.calls"] + counters["prof.cache.miss_compute.calls"] \
        == lookups
    # OPTIMAL's 24 orders, RANK's and RANDOM's one, then each index policy's
    # probs, stage durations and index table (N, M) float64, strides and
    # stage counts (N,) int32
    dynamic = 3 * n * m * 8 + 2 * n * 4
    assert counters["prof.ops.h2d_bytes"] == _h2d_bytes(n, m, 24 + 1 + 1) + 2 * dynamic

    ranges = _ranges(prof)
    plans = [r for r in ranges if r[0].startswith("entry.plan.")]
    ops = [r for r in ranges if r[0] in OPS]
    inner = [r for r in ranges if r[0] in ("ops.args", "ops.launch")]
    assert len(plans) == sum(hist[k]["count"] for k in hist if k.startswith("prof.entry.plan."))
    assert len(ops) == 5 and len(inner) == 10
    assert not [r for r in ranges if r[0].startswith("cache.")]  # probes: registry only
    side_by_side = sorted(plans + ops, key=lambda r: r[1])
    for (a, _, a1), (b, b0, _) in zip(side_by_side, side_by_side[1:]):
        assert a1 <= b0, (a, b)
    for name, t0, t1 in inner:
        assert any(o0 <= t0 and t1 <= o1 for _, o0, o1 in ops), name


def test_optimal_builds_the_bytes_of_its_orders(registry):
    jobs = _group(n=4, m=3)
    profiling.enable(True)
    ev.evaluate(jobs, "optimal", device="cpu")
    assert registry.snapshot()["counters"]["prof.ops.h2d_bytes"] == _h2d_bytes(4, 3, 24)


def test_nothing_is_recorded_with_profiling_off(registry):
    profiling.enable(False)
    assert profiling.span("a") is profiling.span("b")  # one shared no-op
    assert profiling.tick() == 0.0
    prof = _profiled(lambda: ev.evaluate_many(_group(), ALGS, np.random.default_rng(0),
                                              device="cpu"))
    assert registry.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert _ranges(prof) == []


def _launch_each_wrapper(monkeypatch, n, m):
    """One launch of ``sojourn_enum``, ``dynamic_sojourn_enum`` and
    ``dynamic_sojourn_mc`` for one order or table of ``n`` jobs of ``m``
    stages (K = m**n), down to the kernel's call: the tensors are on the
    meta device, which takes the wrappers' launch path but holds no data,
    and the library call is left out."""
    dev = torch.device("meta")
    monkeypatch.setattr(kernel, "launches", dict(kernel.launches))
    monkeypatch.setattr(dynamic, "launches", dict(dynamic.launches))

    def launch(stem, signatures, entry, device, n_orders, *args, **kw):
        return (torch.empty(n_orders, dtype=torch.float64, device=dev),) * 2

    monkeypatch.setattr(kernel, "launch", launch)

    def t(dtype, *shape):
        return torch.empty(shape, dtype=dtype, device=dev)

    f64, i32 = torch.float64, torch.int32
    kernel.sojourn_enum(t(f64, 1, n, m), t(f64, 1, n, m), t(i32, 1, n), t(i32, 1, n), m**n)
    dynamic.dynamic_sojourn_enum(t(f64, n, m), t(f64, n, m), t(f64, 1, n, m), t(i32, n),
                                 t(i32, n), m**n, n * m)
    dynamic.dynamic_sojourn_mc(t(f64, n, m), t(f64, n, m), t(f64, 1, n, m), t(i32, n), 7,
                               1 << 20, n * m)
    assert kernel.launches["sojourn_enum"] == 1
    assert dynamic.launches == {"dynamic_sojourn_enum": 1, "dynamic_sojourn_mc": 1}


@pytest.mark.parametrize("n,m,suffix", [(26, 2, 8), (13, 4, 5)])
def test_the_kernels_count_the_regime_of_their_shapes(registry, monkeypatch, n, m, suffix):
    assert kernel.suffix_length(n, 1, m**n) == suffix
    profiling.enable(True)
    _launch_each_wrapper(monkeypatch, n, m)
    counters = registry.snapshot()["counters"]
    assert counters["prof.ops.enum_suffix"] == suffix
    assert counters["prof.ops.dynamic_entries"] == 2 * n * m  # one enum, one MC launch


def test_the_kernels_count_nothing_with_profiling_off(registry, monkeypatch):
    profiling.enable(False)
    _launch_each_wrapper(monkeypatch, 13, 4)
    profiling.count("ops.enum_suffix", 5)
    assert registry.snapshot()["counters"] == {}


def test_the_outermost_host_events_are_the_programs_spans(registry, monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    from portbench.harness import trace

    profiling.enable(True)
    prof = _profiled(lambda: ev.evaluate_many(_group(), ALGS, np.random.default_rng(0),
                                              device="cpu"))
    tr, _ = trace.from_profiler(prof, "portbench.window")
    names = [h[0] for h in tr.host]
    assert "entry.plan.optimal" in names and "sojourn_eval.static.enum.cpu" in names
    assert "entry.plan.group" in names and "sojourn_eval.dynamic.enum.cpu" in names
    assert "ops.args" not in names and "ops.launch" not in names


def test_the_ops_import_first_in_a_fresh_interpreter():
    code = ("import repro_torch.kernels.sojourn_eval\n"
            "from repro_torch.obs import TraceRecorder\n"
            "import repro_torch.core.evaluator\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert done.returncode == 0, done.stderr
