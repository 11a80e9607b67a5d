"""Port parity of the cluster manager and the replay CLI, against ``repro``.

``ClusterManager.run`` on both sides over the same workload, in the three
scenarios of the study's ``table_faults`` (clean; node failures with
8 nodes a server and stragglers; elastic resizes to 12 and then 4
servers) and a few more interleavings: the ``ClusterResult`` fields, every
job's restarts and straggler re-dispatches, the trace records and the
metrics snapshot must be equal, not close.  Then ``python -m
repro_torch.obs.report`` against ``python -m repro.obs.report``: the same
trace file and the same metrics JSON apart from its wall-clock fields,
each side writing under ``tmp_path``.
"""

import dataclasses
import json

import numpy as np
import pytest

from repro.cluster.faults import FaultConfig as RefFaultConfig
from repro.cluster.manager import ClusterManager as RefManager
from repro.cluster.manager import TrainingJob as RefTrainingJob
from repro.core import jobs as ref_jobs
from repro.core import policies as ref_policies
from repro.obs import MetricsRegistry as RefRegistry
from repro.obs import TraceRecorder as RefRecorder
from repro.obs import report as ref_report
from repro_torch.cluster import ClusterManager, FaultInjector, TrainingJob
from repro_torch.cluster.faults import FaultConfig
from repro_torch.core import policies
from repro_torch.core.jobs import JobSpec, from_reference
from repro_torch.obs import MetricsRegistry, TraceRecorder
from repro_torch.obs import report

FAULTY = dict(mtbf_hours=0.002, restart_overhead=0.5, straggler_prob=0.05,
              straggler_slowdown=5.0)
SCENARIOS = {
    "clean": {},
    "faulty": dict(fault_cfg=FAULTY, nodes_per_server=8),
    "elastic": dict(resize_events=[(20.0, 12), (60.0, 4)]),
    "faulty_elastic": dict(fault_cfg=dict(mtbf_hours=0.004, restart_overhead=0.1,
                                          straggler_prob=0.2, straggler_slowdown=5.0,
                                          deadline_factor=2.0),
                           nodes_per_server=8, resize_events=[(2.0, 16), (6.0, 3), (10.0, 10)]),
}


def _workload(n=300, servers=8):
    """``table_faults``' construction: offered load about twice capacity."""
    rng = np.random.default_rng(21)
    arrivals = np.sort(rng.uniform(0, n * 0.75 / (2 * servers), n))
    ref = ref_jobs.generate_workload(rng, n, num_stages=3, workload_set=1, arrivals=arrivals)
    return from_reference(ref), ref


def _run(side, specs, policy, scenario, seed=5, servers=8, observer=None):
    mgr_cls, job_cls, cfg_cls, rec, reg = {
        "port": (ClusterManager, TrainingJob, FaultConfig, TraceRecorder(), MetricsRegistry()),
        "ref": (RefManager, RefTrainingJob, RefFaultConfig, RefRecorder(), RefRegistry()),
    }[side]
    kw = dict(SCENARIOS[scenario])
    if "fault_cfg" in kw:
        kw["fault_cfg"] = cfg_cls(**kw["fault_cfg"])
    jobs = [job_cls(spec=s) for s in specs]
    mgr = mgr_cls(jobs, servers, policy=policy, rng=np.random.default_rng(seed), **kw)
    res = mgr.run(observer=observer, recorder=rec, metrics=reg)
    per_job = [(j.stage, j.completed, j.success, j.restarts, j.straggler_redispatches)
               for j in jobs]
    return dataclasses.asdict(res), per_job, rec.records, reg.snapshot()


@pytest.mark.parametrize("policy", ["rank", "serpt", "sr", "fifo"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_manager_identical(scenario, policy):
    port_specs, ref_specs = _workload()
    port = _run("port", port_specs, policy, scenario)
    ref = _run("ref", ref_specs, policy, scenario)
    res, per_job, records, snapshot = port
    assert res == ref[0]
    assert per_job == ref[1]  # NaN-free: every job completes
    assert records == ref[2]
    assert snapshot == ref[3]
    assert res["n_jobs"] == 300
    if scenario.startswith("faulty"):
        assert res["restarts"] > 0 and res["straggler_redispatches"] > 0
        assert snapshot["counters"]["jobs.restarts"] == res["restarts"]


def test_server_accounting_under_faults_and_resize():
    """The legacy per-event observer sees the same events as the
    reference's, and at each the pool's drain rule: servers beyond the
    target are only busy ones, retired as they release, so a pool over its
    target has no free server."""
    port_specs, ref_specs = _workload(120)
    seen = {"port": [], "ref": []}

    def observer(side):
        def fn(engine, now):
            pool = engine.pool
            assert 0 <= pool.free <= pool.target
            assert pool.free == 0 or len(pool.running) + pool.free <= pool.target
            seen[side].append((now, pool.free, pool.busy, pool.target))
        return fn

    with pytest.warns(DeprecationWarning):
        port = _run("port", port_specs, "rank", "faulty_elastic", observer=observer("port"))
    with pytest.warns(DeprecationWarning):
        ref = _run("ref", ref_specs, "rank", "faulty_elastic", observer=observer("ref"))
    assert port[:3] == ref[:3]
    assert seen["port"] == seen["ref"] and len(seen["port"]) > 120


def test_real_runner_identical():
    """A runner callback (metric gate) overrides the realized outcome."""
    def runner_for(calls):
        def runner(job, stage):
            calls.append((job.name, stage))
            return 0.5 + 0.1 * len(calls), stage == 1
        return runner

    results = []
    for mgr_cls, job_cls, spec_cls in ((ClusterManager, TrainingJob, JobSpec),
                                       (RefManager, RefTrainingJob, ref_jobs.JobSpec)):
        spec = spec_cls(sizes=np.array([1.0, 2.0, 3.0]), probs=np.array([0.1, 0.1, 0.8]))
        calls = []
        jobs = [job_cls(spec=spec, runner=runner_for(calls), name=f"j{i}") for i in range(3)]
        res = mgr_cls(jobs, 2, rng=np.random.default_rng(0)).run()
        results.append((dataclasses.asdict(res), calls, [j.completed for j in jobs]))
    assert results[0] == results[1]
    assert results[0][0]["n_success"] == 0


def test_fault_injector_draws():
    cfg = FaultConfig(mtbf_hours=1.0, straggler_prob=0.5)
    inj, ref = FaultInjector(cfg, np.random.default_rng(3)), np.random.default_rng(3)
    for now in (0.0, 10.0, 50.0):
        assert inj.next_failure_time(now, 16) == now + float(ref.exponential(3600.0 / 16))
        straggled = ref.uniform() < 0.5
        assert inj.stage_runtime(2.0) == ((8.0, True) if straggled else (2.0, False))


def _report(side, out, argv):
    main = {"port": report.main, "ref": ref_report.main}[side]
    pol = {"port": policies, "ref": ref_policies}[side]
    pol.clear_workload_cache()
    pol.reset_cache_stats()
    assert main([*argv, "--out", str(out)]) == 0
    doc = json.loads((out / "metrics.json").read_text())
    trace_obj = json.loads((out / "trace.json").read_text())
    doc["run"].pop("wall_s")
    return doc, trace_obj


@pytest.mark.parametrize("argv", [
    ["--jobs", "300", "--servers", "8", "--faults", "--validate"],
    ["--jobs", "120", "--servers", "4", "--policy", "sr", "--resize", "20000", "2"],
], ids=["faults", "resize"])
def test_report_cli_identical(tmp_path, capsys, argv):
    port = _report("port", tmp_path / "port", argv)
    ref = _report("ref", tmp_path / "ref", argv)
    assert port == ref
    assert "run metrics" in capsys.readouterr().out
    if "--validate" in argv:
        assert port[0]["run"]["trace_schema"]["events"] == len(port[1]["traceEvents"])
        assert port[0]["counters"]["jobs.restarts"] > 0


def test_report_bench_overhead(tmp_path):
    out = tmp_path / "port"
    assert report.main(["--jobs", "80", "--servers", "4", "--bench-overhead",
                        "--out", str(out)]) == 0
    ov = json.loads((out / "metrics.json").read_text())["run"]["overhead"]
    assert ov["events"] > 0 and ov["max_relerr"] == 0.0


def test_report_default_out_is_its_own(tmp_path, monkeypatch):
    """Without ``--out`` the port writes ``artifacts/obs_torch``, never the
    reference's ``artifacts/obs``."""
    monkeypatch.chdir(tmp_path)
    assert report.main(["--jobs", "40", "--servers", "2"]) == 0
    assert sorted(p.name for p in (tmp_path / "artifacts").iterdir()) == ["obs_torch"]
    assert (tmp_path / "artifacts" / "obs_torch" / "metrics.json").is_file()
