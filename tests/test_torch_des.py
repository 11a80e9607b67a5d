"""Port parity of the online path: the DES engine, ``simulate``, the trace
synthesizer, the recorder and the run metrics, against ``repro``.

The bar is exact equality, not a tolerance: the port keeps the
reference's data structures (``heapq`` with an insertion counter,
same-instant batches, float64 NumPy arrays), so the same inputs give the
same ``SimResult`` fields, the same trace-record tuples, the same metrics
snapshots and the same Chrome trace.  Inputs are seeded NumPy, made on
both sides by each package's own ``synthesize_trace`` or ``JobSpec``.

The last tests hold an exhaustive DES (every outcome combination,
weighted by its probability) to the port's plain ``expected_sojourn_dynamic``
within 1e-9, on index tables with no ties and no non-finite entry: the
DES breaks index ties by insertion order where the lockstep evaluators
break them by job position, and serves a ``+inf``-index job last where
they never seat it (ROADMAP fault R2).
"""

import csv
import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest

from repro.core import jobs as ref_jobs
from repro.core import policies as ref_policies
from repro.core import simulator as ref_sim
from repro.core import trace as ref_trace
from repro.obs import MetricsRegistry as RefRegistry
from repro.obs import TraceRecorder as RefRecorder
from repro_torch.core import evaluator as ev
from repro_torch.core import policies, simulator, trace
from repro_torch.core.des import ReadyQueue, ServerPool
from repro_torch.core.des.events import EngineObserver, LegacyObserverShim, TraceEvent
from repro_torch.core.jobs import JobSpec, from_reference, generate_workload
from repro_torch.obs import MetricsRegistry, TraceRecorder, validate_chrome_trace

RTOL = 1e-9
POLICIES = ("fifo", "serpt", "rank", "sr")
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    """``chip_smoke.py``'s DES check draws its groups with the same
    ``ragged_group`` and ``untied`` as these tests."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _same_jobs(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert np.array_equal(a.sizes, b.sizes)
        assert np.array_equal(a.probs, b.probs)
        assert (a.arrival, a.job_id, a.outcome_stage) == (b.arrival, b.job_id, b.outcome_stage)


def _traces(n_jobs, seed=0, success_prob=None, duration_days=None):
    duration = 75.0 * n_jobs / 109_967 if duration_days is None else duration_days
    kw = dict(n_jobs=n_jobs, duration_days=duration, success_prob=success_prob)
    return (trace.synthesize_trace(np.random.default_rng(seed), **kw),
            ref_trace.synthesize_trace(np.random.default_rng(seed), **kw))


def _both(port_jobs, ref_jobs_, n_servers, **kw):
    """Run ``simulate`` on both sides with a recorder and a registry each;
    return ``(port, ref)`` triples of (result, records, snapshot)."""
    out = []
    for sim, jobs, rec, reg in ((simulator, port_jobs, TraceRecorder(), MetricsRegistry()),
                                (ref_sim, ref_jobs_, RefRecorder(), RefRegistry())):
        kwargs = dict(kw)
        if "rng_seed" in kwargs:
            kwargs["rng"] = np.random.default_rng(kwargs.pop("rng_seed"))
        res = sim.simulate(jobs, n_servers, recorder=rec, metrics=reg, **kwargs)
        out.append((res, rec, reg.snapshot()))
    return out


def _assert_identical(port, ref):
    (res_p, rec_p, snap_p), (res_r, rec_r, snap_r) = port, ref
    assert dataclasses.asdict(res_p) == dataclasses.asdict(res_r)
    assert rec_p.records == rec_r.records
    assert rec_p.n_runs == rec_r.n_runs == 1
    assert snap_p == snap_r


@pytest.mark.parametrize("n_jobs,success_prob", [(300, None), (1000, 0.5), (2000, 0.25)])
def test_synthesize_trace_identical(n_jobs, success_prob):
    port, ref = _traces(n_jobs, seed=n_jobs, success_prob=success_prob)
    _same_jobs(port, ref)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("n_servers", [1, 2, 3, 8])
def test_simulate_trace_identical(n_servers, policy):
    port_jobs, ref_jobs_ = _traces(600, seed=3)
    _assert_identical(*_both(port_jobs, ref_jobs_, n_servers, policy=policy))


@pytest.mark.parametrize("policy", ["rank", "sr"])
def test_stage_overhead_identical(policy):
    port_jobs, ref_jobs_ = _traces(400, seed=5, success_prob=0.5)
    for overhead in (0.0, 0.5):
        _assert_identical(*_both(port_jobs, ref_jobs_, 3, policy=policy,
                                 stage_overhead=overhead))


def test_precomputed_index_table_identical():
    port_jobs, ref_jobs_ = _traces(400, seed=6)
    table = policies.index_table(port_jobs, "serpt") * 0.5 + policies.index_table(port_jobs, "sr")
    assert np.array_equal(table, ref_policies.index_table(ref_jobs_, "serpt") * 0.5
                          + ref_policies.index_table(ref_jobs_, "sr"))
    _assert_identical(*_both(port_jobs, ref_jobs_, 4, policy="custom", idx_table=table))


def test_paper_section_v_example():
    """Single server, two jobs with arrivals: job 1 stage 1 [0, 4], job 2
    both stages [4, 6], job 1 stage 2 [6, 12]."""
    def jobs(cls):
        return [cls(sizes=[4, 10], probs=[0.4, 0.6], arrival=0.0, job_id=0, outcome_stage=1),
                cls(sizes=[1, 2], probs=[0.2, 0.8], arrival=2.0, job_id=1, outcome_stage=1)]

    port, ref = _both(jobs(JobSpec), jobs(ref_jobs.JobSpec), 1, policy="rank")
    _assert_identical(port, ref)
    assert port[0].n_success == 2
    assert port[0].mean_sojourn_successful == (12 + 4) / 2
    spans = [(g["job"], g["stage"], g["start"], g["end"]) for g in port[1].gantt()]
    assert spans == [(0, 0, 0.0, 4.0), (1, 0, 4.0, 5.0), (1, 1, 5.0, 6.0), (0, 1, 6.0, 12.0)]


@pytest.mark.parametrize("n_servers", [1, 3])
def test_same_instant_batch_with_sampled_outcomes(n_servers):
    """All jobs at t=0 contend by index in one batch; outcomes without a
    fixed stage come from the shared rng, job by job, in the reference's
    order."""
    ref_w = ref_jobs.generate_workload(np.random.default_rng(8), 40, num_stages=3,
                                       arrivals=np.zeros(40))
    port_w = from_reference(ref_w)
    for policy in POLICIES:
        _assert_identical(*_both(port_w, ref_w, n_servers, policy=policy, rng_seed=9))
    with pytest.raises(ValueError, match="need an rng"):
        simulator.simulate(port_w, n_servers)


@pytest.mark.parametrize("n_servers", [1, 2])
def test_infinite_index_served_last_on_both_sides(n_servers):
    """Fault R2: a zero-success-probability job has rank index +inf; the
    DES serves it last, on both sides."""
    def jobs(cls):
        return [cls(sizes=[1.0, 2.0], probs=[1.0, 0.0], job_id=0, outcome_stage=1),
                cls(sizes=[0.5, 1.5], probs=[0.4, 0.6], job_id=1, outcome_stage=1),
                cls(sizes=[1.0, 3.0], probs=[0.3, 0.7], job_id=2, outcome_stage=1)]

    port_w = jobs(JobSpec)
    assert np.isinf(policies.index_table(port_w, "rank")[0, 0])
    port, ref = _both(port_w, jobs(ref_jobs.JobSpec), n_servers, policy="rank")
    _assert_identical(port, ref)
    dispatched = [r[2] for r in port[1].records if r[1] == 1]  # EV_DISPATCH
    assert dispatched.index(0) >= n_servers  # queued behind every finite index
    if n_servers == 1:
        assert dispatched[-2:] == [0, 0]


def test_chrome_trace_identical_and_valid(tmp_path):
    port_jobs, ref_jobs_ = _traces(300, seed=11)
    (_, rec_p, _), (_, rec_r, _) = _both(port_jobs, ref_jobs_, 5, policy="rank")
    obj = rec_p.write_chrome_trace(str(tmp_path / "trace.json"))
    assert json.loads((tmp_path / "trace.json").read_text()) == json.loads(json.dumps(obj))
    assert obj == rec_r.to_chrome_trace()
    summary = validate_chrome_trace(obj)
    assert summary["by_phase"]["X"] == len(rec_p.gantt())
    assert rec_p.counts() == rec_r.counts()
    assert np.array_equal(rec_p.queue_depth_series(), rec_r.queue_depth_series())
    assert np.array_equal(rec_p.utilization_series(), rec_r.utilization_series())
    assert [e.as_record() for e in rec_p.events()] == rec_r.records
    with pytest.raises(ValueError, match="negative dur"):
        validate_chrome_trace({"traceEvents": [{"ph": "X", "name": "a", "ts": 0, "dur": -1,
                                                "pid": 0, "tid": 0}]})


def test_batch_size_is_invisible():
    port_jobs, _ = _traces(300, seed=12)
    recs = []
    for batch in (1, 7, 4096):
        rec = TraceRecorder(batch_size=batch)
        simulator.simulate(port_jobs, 3, "sr", recorder=rec)
        recs.append(rec.records)
    assert recs[0] == recs[1] == recs[2]


def test_legacy_observer_warns_and_sees_every_event():
    port_jobs, ref_jobs_ = _traces(200, seed=13)
    seen = {"port": [], "ref": []}
    with pytest.warns(DeprecationWarning, match="deprecated"):
        simulator.simulate(port_jobs, 2, "rank",
                           recorder=lambda eng, now: seen["port"].append((now, eng.n_done)))
    with pytest.warns(DeprecationWarning):
        ref_sim.simulate(ref_jobs_, 2, "rank",
                         recorder=lambda eng, now: seen["ref"].append((now, eng.n_done)))
    assert seen["port"] == seen["ref"] and seen["port"]
    assert not isinstance(TraceRecorder(), LegacyObserverShim)
    assert isinstance(TraceRecorder(), EngineObserver)


def test_engine_pieces():
    """ReadyQueue ties by insertion order; ServerPool's drain-at-boundary
    shrink; a stale STAGE_DONE after an abort."""
    q = ReadyQueue()
    for idx, job in ((2.0, 5), (1.0, 7), (2.0, 3), (1.0, 4)):
        q.push(idx, job)
    assert q.peek_index() == 1.0
    assert [q.pop() for _ in range(4)] == [7, 4, 5, 3]
    assert q.peek_index() == np.inf
    pool = ServerPool(3)
    for job in (0, 1):
        pool.acquire(job)
    pool.resize(1)
    assert (pool.free, pool.busy, pool.target) == (0, 2, 1)
    pool.release(0)
    assert (pool.free, pool.busy) == (0, 1)
    pool.release(1)
    assert (pool.free, pool.busy) == (1, 0)
    pool.resize(3)
    assert (pool.free, pool.busy, pool.target) == (3, 0, 3)
    pool.acquire(2)
    with pytest.raises(RuntimeError, match="twice"):
        pool.acquire(2)
    assert TraceEvent.from_record((1.0, 1, 2, 0, 3.0, 0, 1, 0, 1)).name == "dispatch"


def test_load_trace_csv_identical(tmp_path):
    path = tmp_path / "trace.csv"
    rng = np.random.default_rng(14)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["job_id", "arrival", "category", "attempt_durations"])
        w.writeheader()
        for i in range(60):
            durs = rng.lognormal(6.0, 1.5, size=rng.integers(1, 5))
            w.writerow({"job_id": i, "arrival": float(rng.uniform(0, 1e5)),
                        "category": ("passed", "failed", "killed")[i % 3],
                        "attempt_durations": ";".join(repr(float(d)) for d in durs)})
    for sp in (None, 0.5):
        port = trace.load_trace_csv(str(path), np.random.default_rng(15), success_prob=sp)
        ref = ref_trace.load_trace_csv(str(path), np.random.default_rng(15), success_prob=sp)
        _same_jobs(port, ref)
        _assert_identical(*_both(port, ref, 2, policy="rank"))


# ---------------------------------------------------------------------------
# Exhaustive DES against the exact dynamic evaluator (plain version)
# ---------------------------------------------------------------------------


def des_exhaustive(jobs, policy, n_servers):
    outcomes, weights = ev.enumerate_outcomes(jobs)
    total = 0.0
    for outcome, w in zip(outcomes, weights):
        fixed = [dataclasses.replace(j, outcome_stage=int(s)) for j, s in zip(jobs, outcome)]
        total += w * simulator.simulate(fixed, n_servers, policy).mean_sojourn_successful
    return total


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", ["sr", "serpt"])
def test_exhaustive_des_matches_dynamic_evaluator(seed, policy):
    cs = _chip_smoke()
    rng = np.random.default_rng(100 + seed)
    jobs = cs.ragged_group(rng, 5, 3)
    while not cs.untied(jobs, policy):
        jobs = cs.ragged_group(rng, 5, 3)
    for w in (1, 2, 3):
        want = ev.expected_sojourn_dynamic(jobs, policy, n_servers=w, device="cpu")
        got = des_exhaustive(jobs, policy, w)
        assert abs(got - want) <= RTOL * abs(want), (w, got, want)


def test_exhaustive_des_uniform_stages():
    untied = _chip_smoke().untied
    rng = np.random.default_rng(5)
    jobs = generate_workload(rng, 6, num_stages=2)
    while not untied(jobs, "sr"):
        jobs = generate_workload(rng, 6, num_stages=2)
    for w in (1, 2, 3):
        want = ev.expected_sojourn_dynamic(jobs, "sr", n_servers=w, device="cpu")
        assert abs(des_exhaustive(jobs, "sr", w) - want) <= RTOL * abs(want)
