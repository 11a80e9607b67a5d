"""One run of a cell: set-up, the measured window, the check, the result.

* **Set-up** (``setup_s``, from the process's start): the groups drawn
  from ``--seed`` (:mod:`.traffic`), as many as ``max_groups_per_s`` times
  the window's seconds, and the program's ``JobSpec`` of every job; the
  card's first use; one more group of each size in the traffic's block
  through the evaluator, which warms every shape the window uses (the
  first run in a checkout builds the kernels here).
* **Window**: one caller in a closed loop, the next group as soon as the
  previous one's results are on the host, as the paper's study loop does:
  ``evaluate_many(jobs, policies, rng, mc_samples=S)``, every group new
  (a group seen before would hit the program's workload cache).  A window
  that runs out of groups fails the run.  The generator ``rng`` comes
  from the seed; its state before each group is kept for the check.
* **Check**, once the window has closed and the peak memory is read: a
  sample of the window's groups drawn from the seed, each worked out again
  by the plain reference (:mod:`portbench.reference.evaluator`) from the
  benchmark's own arrays and the generator's state, and each policy's
  relative gap held against the configuration's limit.
* **Trace** (``--trace 1``): the program's profiling spans on, and
  ``torch.profiler`` over exactly the window; the per-layer readers get a
  :class:`Window`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import sys
import time
import traceback
from pathlib import Path

import numpy as np

from portbench.harness import traffic as traffic_mod
from portbench.harness import work as work_mod
from portbench.harness.peaks import Peaks
from portbench.harness.trace import Trace

__all__ = ["Window", "draw", "run"]

#: The host span that marks the measured window in the profiler's trace.
MARKER = "portbench.window"


@dataclasses.dataclass
class Window:
    """What the per-layer readers read: the window's groups and times, the
    program's span totals and launch counts over it, and in a traced run
    on the card the device trace, the peaks and each group's work."""

    n_groups: int
    latencies_s: np.ndarray
    window_s: float
    spans_s: dict[str, float]
    launches: dict[str, int]
    trace: Trace | None
    peaks: Peaks | None
    work: list[dict]


def _log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def _streams(seed: int):
    """Independent generators for the groups, the evaluator, the warm-up
    and the check's sample, all from ``seed``."""
    ss = np.random.SeedSequence(seed % (1 << 64))
    return [np.random.Generator(np.random.PCG64(s)) for s in ss.spawn(4)]


def draw(cell, rng: np.random.Generator, n_groups: int,
         keys: list[tuple[int, int]] | None = None) -> list[tuple[np.ndarray, np.ndarray]]:
    """``n_groups`` groups ``(sizes (N, M), probs (N, M))`` of the cell, of
    the ``(N, workload set)`` keys given or drawn from the traffic's block."""
    cfg = cell.config
    if keys is None:
        keys = traffic_mod.sequence(rng, n_groups, cell.traffic["block"])
    out: list = [None] * n_groups
    for key in sorted(set(keys)):
        where = [g for g, k in enumerate(keys) if k == key]
        wset = cfg["workload_sets"][str(key[1])]
        sizes, probs = traffic_mod.draw_groups(rng, len(where), key[0], int(cfg["num_stages"]),
                                               wset["stage_sizes"], wset["success_probs"])
        for g, s, p in zip(where, sizes, probs):
            out[g] = (s, p)
    return out


def warm_keys(cell) -> list[tuple[int, int]]:
    """One key a group size of the traffic's block: the shapes the window
    uses, each once."""
    first: dict[int, int] = {}
    for n, ws, _ in cell.traffic["block"]:
        first.setdefault(int(n), int(ws))
    return sorted(first.items())


def _check_regime(cell, groups) -> None:
    """The configuration's evaluation must be the one that the evaluator
    takes at each group's size (exact up to ``max_exact_combos``)."""
    cfg = cell.config
    exact = cfg["evaluation"] == "exact"
    for sizes, _ in groups:
        n, m = sizes.shape
        if (m**n <= int(cfg["max_exact_combos"])) != exact:
            raise ValueError(f"{cell.name}: a group of {n} jobs with {m} stages is not "
                             f"evaluated by {cfg['evaluation']}")


def _specs(groups):
    from repro_torch.core.jobs import JobSpec

    return [[JobSpec(sizes=s[i], probs=p[i], job_id=i) for i in range(len(s))]
            for s, p in groups]


def _launch_counts() -> dict[str, int]:
    from repro_torch.kernels.sojourn_eval import dynamic, kernel

    return {**kernel.launches, **dynamic.launches}


def _span_totals() -> dict[str, float]:
    from repro_torch.obs import metrics

    hist = metrics.get_registry().snapshot()["histograms"]
    return {name: h.get("sum", 0.0) for name, h in hist.items()
            if name.startswith("prof.sojourn_eval.") and name.endswith(".seconds")}


def _generator(state: dict) -> np.random.Generator:
    bg = getattr(np.random, state["bit_generator"])()
    bg.state = state
    return np.random.Generator(bg)


def _device_info(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


@dataclasses.dataclass
class _Loop:
    latencies_s: list[float]
    states: list[dict]
    results: list[dict | None]
    failed: int
    window_s: float
    spans_s: dict[str, float]
    launches: dict[str, int]
    prof: object | None


def _loop(specs, policies, rng, kw, dev, seconds: float, trace: bool) -> _Loop:
    """The measured window: one group after another until ``seconds`` have
    passed; a group that raises counts as failed."""
    import torch

    from repro_torch.core import evaluator

    spans0, launches0 = _span_totals(), _launch_counts()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    lat, states, results, failed = [], [], [], 0
    try:
        with torch.profiler.record_function(MARKER) if trace else contextlib.nullcontext():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                g = len(lat)
                if g >= len(specs):
                    raise RuntimeError(f"the window ran out of groups after {g}: raise "
                                       "max_groups_per_s in a new traffic file")
                states.append(rng.bit_generator.state)
                t = time.perf_counter()
                try:
                    res = evaluator.evaluate_many(specs[g], policies, rng, device=dev, **kw)
                except Exception:  # counted and reported; the window goes on
                    if not failed:
                        traceback.print_exc()
                    failed, res = failed + 1, None
                lat.append(time.perf_counter() - t)
                results.append(res)
            window_s = time.perf_counter() - t0
    finally:
        if prof is not None:
            t_stop = time.perf_counter()
            prof.stop()
            _log(f"profiler stopped in {time.perf_counter() - t_stop:.3f} s")
    spans = {k: v - spans0.get(k, 0.0) for k, v in _span_totals().items()}
    launches = {k: v - launches0.get(k, 0) for k, v in _launch_counts().items()}
    return _Loop(lat, states, results, failed, window_s, spans, launches, prof)


def _compare(cell, groups, loop: _Loop, rng_pick, dev) -> tuple[dict, bool]:
    """Each policy's largest relative gap to the reference over a sample of
    the window's groups drawn from the seed, beside the configuration's
    limit; and whether every gap is within it."""
    import torch

    from portbench.reference import evaluator as ref

    cfg = cell.config
    limit = float(cfg["limit"]["rel_gap"])
    done = [g for g, r in enumerate(loop.results) if r is not None]
    k = min(int(cell.traffic["compare_groups"]), len(done))
    gaps = {p: 0.0 for p in cfg["policies"]}
    for i in sorted(rng_pick.choice(len(done), size=k, replace=False)) if k else ():
        g = done[i]
        sizes, probs = groups[g]
        want = ref.evaluate(sizes, probs, cfg, _generator(loop.states[g]), torch.float64, dev)
        for p in cfg["policies"]:
            gap = abs(loop.results[g][p] - want[p]) / abs(want[p])
            gaps[p] = max(gaps[p], gap) if math.isfinite(gap) else math.inf
    check = {f"rel_gap.{p}": {"value": v, "limit": limit} for p, v in gaps.items()}
    return check, k > 0 and all(v <= limit for v in gaps.values())


def run(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float | None = None, out_dir: Path | None = None) -> dict:
    """One run of ``cell`` on ``device``; returns the result line as a dict.
    ``t_start`` is the process's start (set-up counts from it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from repro_torch.core import evaluator
    from repro_torch.obs import profiling

    cfg, trf = cell.config, cell.traffic
    dev = torch.device(device)
    policies = tuple(cfg["policies"])
    kw = {"mc_samples": int(cfg["mc_samples"])} if cfg["evaluation"] == "monte_carlo" else {}
    rng_groups, rng_eval, rng_warm, rng_pick = _streams(seed)
    n_window = math.ceil(float(trf["max_groups_per_s"]) * seconds)
    t_draw = time.perf_counter()
    groups = draw(cell, rng_groups, n_window)
    keys = warm_keys(cell)
    warm = draw(cell, rng_warm, len(keys), keys=keys)
    _check_regime(cell, groups + warm)
    specs = _specs(groups)
    t_card = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    t_warm = time.perf_counter()
    for spec in _specs(warm):
        evaluator.evaluate_many(spec, policies, rng_warm, device=dev, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gc.collect()
    gc.freeze()  # the drawn groups stay out of the collector's scans in the window
    t_end = time.perf_counter()
    setup_s = t_end - t_start
    _log(f"{cell.name} seed {seed}: set-up {setup_s:.3f} s (imports {t_draw - t_start:.3f}, "
         f"{n_window} groups drawn {t_card - t_draw:.3f}, card {t_warm - t_card:.3f}, "
         f"warm-up {t_end - t_warm:.3f})")

    was_profiling = profiling.enabled()
    profiling.enable(bool(trace))
    try:
        loop = _loop(specs, policies, rng_eval, kw, dev, seconds, trace)
    finally:
        profiling.enable(was_profiling)
        gc.unfreeze()
    n = len(loop.latencies_s)
    mem_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    _log(f"{cell.name}: {n} groups in {loop.window_s:.3f} s, {loop.failed} failed")

    del specs  # the check runs with the program's state freed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    window_groups = groups[:n]
    check, correct = _compare(cell, window_groups, loop, rng_pick, dev)
    correct = correct and loop.failed == 0
    _log(f"{cell.name}: check in {time.perf_counter() - t_check:.3f} s")

    lat = np.asarray(loop.latencies_s)
    e2e = {"groups_per_s": n / loop.window_s,
           "group_p95_ms": float(np.percentile(lat, 95)) * 1e3 if n else math.nan,
           "setup_s": setup_s}
    info = _device_info(dev)
    info["memory_peak_bytes"] = mem_peak
    peaks = None
    if dev.type == "cuda":
        from portbench.harness import peaks as peaks_mod

        peaks = peaks_mod.query(dev.index or 0)
        info.update(max_sm_clock_mhz=peaks.max_sm_clock_mhz, power_limit_w=peaks.power_limit_w)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{cell.name}.{seed}.latencies.json").write_text(json.dumps(loop.latencies_s))
    result = {"correct": bool(correct), "attempted": n, "failed": loop.failed}
    if not trace:
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    else:
        tr = bounds = None
        if dev.type == "cuda":
            from portbench.harness import trace as trace_mod

            t_trace = time.perf_counter()
            tr, bounds = trace_mod.from_profiler(loop.prof, MARKER)
            if out_dir is not None:
                tr.write_chrome(out_dir / f"{cell.name}.{seed}.trace.json.gz")
            _log(f"{cell.name}: trace of {len(tr.device)} device and {len(tr.host)} host "
                 f"operations read in {time.perf_counter() - t_trace:.3f} s")
        win = Window(n, lat, loop.window_s, loop.spans_s, loop.launches, tr, peaks,
                     [work_mod.group_work(cell, p) for _, p in window_groups])
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(win)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["metrics"] = metrics
        if tr is not None:
            info.update(busy_s=tr.busy_s, window_s=bounds[1] - bounds[0])
            result["breakdown"] = tr.breakdown(bounds)
    result["device"] = info
    result["check"] = check
    return result
