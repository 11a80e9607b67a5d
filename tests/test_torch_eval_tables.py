"""The port's ``table_eval_perf``, ``table_eval_dynamic`` and
``table_eval_mc`` (``repro_torch.launch.study``) against
``benchmarks/run.py``'s.

The tables run small here (``n_jobs`` 8-12, the plain PyTorch versions
on the CPU, ``out=tmp_path``): their rows carry the reference's keys,
and their own checks hold (fused against seed within 1e-9, the streamed
estimate within 3 sigma).  The reference's tables run only at their
fixed sizes (K = 2**21 and 2**27), too large for the CPU tests, so the
workloads each table draws at its default ``n_jobs`` are held to the
reference's draws from the same seeds instead, and ``table_eval_mc``'s
small-K control (N = 8, seed 0x5EED, 2**12 samples) to the reference's
``expected_sojourn_static`` at the same point: the exact value and the
streamed estimate within 1e-12, the z-score within 1e-9.  The
reference's evaluator needs the ``ref_x64`` fixture (ROADMAP fault R1).
"""

import inspect
import json

import numpy as np
import pytest

from repro.core import evaluator as ref_evaluator
from repro.core import jobs as ref_jobs
from repro.core import policies as ref_policies
from repro.kernels.sojourn_eval.ref import ref_mc_outcomes
from repro_torch.core import jobs, policies
from repro_torch.launch import study
from test_torch_evaluator import ref_x64  # noqa: F401

#: Row keys of the reference's tables (``benchmarks/run.py:255-511``).
PERF_KEYS = ["k_combos", "n_jobs", "orders", "seed_s", "fused_s", "speedup",
             "max_relerr_vs_seed"]
DYNAMIC_KEYS = ["k_combos", "n_jobs", "policy", "seed_s", "fused_s", "speedup",
                "max_relerr_vs_seed"]
MC_KEYS = ["k_combos", "n_jobs", "streamed_samples", "streamed_s", "streamed_samples_per_s",
           "materialized_samples", "materialized_s", "materialized_samples_per_s",
           "throughput_ratio", "control_z_score"]
CONTROL_KEYS = ["k_combos", "n_samples", "exact", "streamed_est", "sigma", "z_score"]


def _saved(path, name):
    with open(path / f"{name}.json") as f:
        saved = json.load(f)
    assert "workload_cache" in saved
    return saved


@pytest.mark.parametrize("n_jobs", [8, 12])
def test_eval_perf_rows(tmp_path, n_jobs):
    rows = study.table_eval_perf(device="cpu", out=str(tmp_path), n_jobs=n_jobs)
    assert [list(r) for r in rows] == [PERF_KEYS]
    (row,) = rows
    assert (row["k_combos"], row["n_jobs"], row["orders"]) == (1 << n_jobs, n_jobs, 2)
    assert row["max_relerr_vs_seed"] <= 1e-9 and row["seed_s"] > 0 and row["fused_s"] > 0
    assert _saved(tmp_path, "BENCH_eval")["rows"] == rows


@pytest.mark.parametrize("n_jobs", [8, 12])
def test_eval_dynamic_rows(tmp_path, n_jobs):
    rows = study.table_eval_dynamic(device="cpu", out=str(tmp_path), n_jobs=n_jobs)
    assert [list(r) for r in rows] == [DYNAMIC_KEYS]
    (row,) = rows
    assert (row["k_combos"], row["policy"]) == (1 << n_jobs, "sr")
    assert row["max_relerr_vs_seed"] <= 1e-9
    assert _saved(tmp_path, "BENCH_eval_dynamic")["rows"] == rows


def test_eval_mc_rows(tmp_path):
    rows = study.table_eval_mc(smoke=True, device="cpu", out=str(tmp_path), n_jobs=12)
    assert [list(r) for r in rows] == [MC_KEYS]
    saved = _saved(tmp_path, "BENCH_eval_mc")
    assert saved["mode"] == "smoke" and saved["device"] == "cpu"
    assert list(saved["clt_control"]) == CONTROL_KEYS
    assert saved["clt_control"]["z_score"] <= 3.0
    assert rows[0]["streamed_samples"] == 1 << 12 and rows[0]["materialized_samples"] == 1 << 10


def _same_jobs(got, want):
    for a, b in zip(policies.padded_arrays(got), ref_policies.padded_arrays(want), strict=True):
        np.testing.assert_array_equal(a, b)


def test_workloads_equal_the_references_draws():
    """At the default ``n_jobs`` (21, 21 and 27) each table's draws from
    its seed (31, 37, 43) equal the reference's: the jobs, and
    ``table_eval_perf``'s random order drawn after them."""
    for seed, sizes in ((31, (21,)), (37, (21,)), (43, (8, 27))):
        g, g_ref = np.random.default_rng(seed), np.random.default_rng(seed)
        for n in sizes:
            _same_jobs(jobs.generate_workload(g, n), ref_jobs.generate_workload(g_ref, n))
        if seed == 31:
            np.testing.assert_array_equal(g.permutation(21), g_ref.permutation(21))
    for fn, n in ((study.table_eval_perf, 21), (study.table_eval_dynamic, 21),
                  (study.table_eval_mc, 27)):
        assert inspect.signature(fn).parameters["n_jobs"].default == n


def test_eval_mc_control_equals_the_reference(tmp_path, ref_x64):
    study.table_eval_mc(smoke=True, device="cpu", out=str(tmp_path), n_jobs=10)
    control = _saved(tmp_path, "BENCH_eval_mc")["clt_control"]
    seed, samples = 0x5EED, 1 << 12
    ctrl = ref_jobs.generate_workload(np.random.default_rng(43), 8)
    order = ref_policies.rank_order(ctrl)
    exact = ref_evaluator.expected_sojourn_static(ctrl, order, impl="xla")
    est = ref_evaluator.expected_sojourn_static(ctrl, order, samples=(seed, samples),
                                                impl="xla")
    assert abs(control["exact"] - exact) <= 1e-12 * abs(exact)
    assert abs(control["streamed_est"] - est) <= 1e-12 * abs(est)
    # the reference's sigma, replayed from the same stream
    sizes, probs, num_stages = ref_policies.padded_arrays(ctrl)
    outcomes, _ = ref_mc_outcomes(probs, num_stages, seed, samples)
    d = sizes[np.arange(len(ctrl))[None, :], outcomes]
    succ = outcomes == num_stages[None, :] - 1
    t = np.cumsum(d[:, order], axis=1)
    cnt = succ.sum(axis=1)
    vals = np.where(cnt > 0, (t * succ[:, order]).sum(axis=1) / np.maximum(cnt, 1), 0.0)
    z = abs(est - exact) / float(vals.std(ddof=1) / np.sqrt(samples))
    assert control["k_combos"] == 256 and control["n_samples"] == samples
    assert abs(control["z_score"] - z) <= 1e-9 * max(z, 1.0)


def test_study_cli_runs_the_eval_tables(tmp_path, capsys):
    """``python -m repro_torch.launch.study --table eval_mc --smoke``: the
    table printed and saved under ``--out``."""
    study.main(["--table", "eval_mc", "--smoke", "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "## eval_mc" in out and "throughput_ratio" in out
    assert _saved(tmp_path, "BENCH_eval_mc")["mode"] == "smoke"
