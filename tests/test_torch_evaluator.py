"""Port parity of the evaluator entry points, and the paper's worked example.

The reference's ``evaluator`` enters float64 through
``jax.experimental.enable_x64``, which JAX 0.9.0 no longer has (ROADMAP,
fault R1); the ``ref_x64`` fixture aliases it to ``jax.enable_x64`` for
one test at a time, so ``src/repro`` stays as it is.  Both sides get an
identical ``np.random.Generator``: the port must draw from it in the
reference's order (``rng.permutation`` for RANDOM, one
``rng.integers(0, MAX_SEED)`` before the policy loop in the Monte-Carlo
regime) and give the same numbers to 1e-9 relative.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import evaluator as ref_ev
from repro.core import jobs as ref_jobs
from repro_torch import quickstart
from repro_torch.core import evaluator as ev
from repro_torch.core.jobs import JobSpec, from_reference
from repro_torch.obs import profiling

RTOL = 1e-9
ALGS = ("optimal", "rank", "serpt", "sr", "random")


@pytest.fixture
def ref_x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _paper_jobs(cls):
    return [cls(sizes=[1, 10], probs=[0.25, 0.75], job_id=0),
            cls(sizes=[3, 6], probs=[0.6, 0.4], job_id=1)]


def test_worked_example_pinned():
    """Paper §III-A: E_SR = 10, E_SERPT = 9.75, E_OPTIMAL = E_RANK = 9.1."""
    jobs = _paper_jobs(JobSpec)
    assert _rel(ev.evaluate(jobs, "sr", device="cpu"), 10.0) <= RTOL
    assert _rel(ev.evaluate(jobs, "serpt", device="cpu"), 9.75) <= RTOL
    order, e_opt = ev.optimal_order(jobs, device="cpu")
    assert _rel(e_opt, 9.1) <= RTOL
    assert list(order) == [0, 1]
    assert _rel(ev.evaluate(jobs, "rank", device="cpu"), 9.1) <= RTOL


def test_worked_example_matches_reference(ref_x64):
    ref, port = _paper_jobs(ref_jobs.JobSpec), _paper_jobs(JobSpec)
    for policy in ("sr", "serpt", "rank", "optimal"):
        assert _rel(ev.evaluate(port, policy, device="cpu"), ref_ev.evaluate(ref, policy)) <= RTOL


@pytest.mark.parametrize("n,m,workload_set", [(5, 2, 1), (4, 3, 4), (6, 2, 5)])
def test_evaluate_matches_reference(ref_x64, n, m, workload_set):
    ref = ref_jobs.generate_workload(np.random.default_rng(n), n, m, workload_set)
    port = from_reference(ref)
    for policy in ALGS:
        want = ref_ev.evaluate(ref, policy, rng=np.random.default_rng(1))
        got = ev.evaluate(port, policy, rng=np.random.default_rng(1), device="cpu")
        assert _rel(got, want) <= RTOL, policy


@pytest.mark.parametrize("n,m,mc_samples", [(6, 3, 4096), (27, 2, 4096)])
def test_evaluate_many_matches_reference(ref_x64, n, m, mc_samples):
    """Both regimes: exact (K <= 2**26) and streamed MC (N=27: K = 2**27)."""
    ref = ref_jobs.generate_workload(np.random.default_rng(40 + n), n, m, 1)
    port = from_reference(ref)
    algs = ALGS if n <= 9 else ("rank", "serpt", "sr", "random")
    g_ref, g_port = np.random.default_rng(99), np.random.default_rng(99)
    want = ref_ev.evaluate_many(ref, algs, g_ref, mc_samples=mc_samples)
    got = ev.evaluate_many(port, algs, g_port, mc_samples=mc_samples, device="cpu")
    assert got.keys() == want.keys()
    for alg in algs:
        assert _rel(got[alg], want[alg]) <= RTOL, alg
    # the generator was consumed identically
    assert g_port.bit_generator.state == g_ref.bit_generator.state


def test_evaluate_many_regime_boundary():
    assert ev.MAX_EXACT_COMBOS == ref_ev.MAX_EXACT_COMBOS == 1 << 26
    assert ev.MAX_MATERIALIZED_COMBOS == ref_ev.MAX_MATERIALIZED_COMBOS == 1 << 21
    jobs = from_reference(ref_jobs.generate_workload(np.random.default_rng(0), 27, 2, 1))
    assert ev.exact_combination_count(jobs) == 1 << 27
    with pytest.raises(ValueError, match="MAX_EXACT_COMBOS"):
        ev.expected_sojourn_static(jobs, np.arange(27), device="cpu")
    with pytest.raises(ValueError, match="MAX_EXACT_COMBOS"):
        ev.expected_sojourn_dynamic(jobs, "sr", device="cpu")


@pytest.mark.parametrize("n,m", [(5, 2), (4, 3)])
def test_optimal_order_matches_reference(ref_x64, n, m):
    ref = ref_jobs.generate_workload(np.random.default_rng(7 * n), n, m, 2)
    order_ref, val_ref = ref_ev.optimal_order(ref)
    order, val = ev.optimal_order(from_reference(ref), device="cpu")
    np.testing.assert_array_equal(order, order_ref)
    assert _rel(val, val_ref) <= RTOL


def test_static_batch_and_all_jobs_match_reference(ref_x64):
    ref = ref_jobs.generate_workload(np.random.default_rng(3), 5, 3, 3)
    orders = np.stack([np.random.default_rng(s).permutation(5) for s in range(4)])
    for samples in (None, (12345, 3000)):
        want = ref_ev.expected_sojourn_static(ref, orders, also_all_jobs=True, samples=samples)
        got = ev.expected_sojourn_static(from_reference(ref), orders, also_all_jobs=True,
                                         samples=samples, device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)


@pytest.mark.parametrize("n_servers", (2, 3))
def test_dynamic_multi_server_matches_reference(ref_x64, n_servers):
    ref = ref_jobs.generate_workload(np.random.default_rng(5), 5, 2, 1)
    port = from_reference(ref)
    for policy in ("sr", "serpt"):
        for samples in (None, (777, 2048)):
            want = ref_ev.expected_sojourn_dynamic(ref, policy, samples=samples,
                                                   n_servers=n_servers)
            got = ev.expected_sojourn_dynamic(port, policy, samples=samples,
                                              n_servers=n_servers, device="cpu")
            assert _rel(got, want) <= RTOL, (policy, samples)


def test_outcome_tables_tier_not_ported():
    """The explicit-table tier, once left for a later slice, is ported: on
    the worked example's enumerated table it gives the paper's values."""
    jobs = _paper_jobs(JobSpec)
    outcomes, weights = ev.enumerate_outcomes(jobs)
    assert _rel(ev.evaluate(jobs, "rank", outcomes=outcomes, weights=weights, device="cpu"),
                9.1) <= RTOL
    assert _rel(ev.expected_sojourn_dynamic(jobs, "sr", outcomes, weights, device="cpu"),
                10.0) <= RTOL


@pytest.mark.parametrize("call", [
    lambda jobs: ev.evaluate(jobs, "rank"),
    lambda jobs: ev.evaluate(jobs, "sr"),
    lambda jobs: ev.optimal_order(jobs),
    lambda jobs: ev.evaluate_many(jobs, ("rank", "sr"), np.random.default_rng(0)),
])
def test_default_device_raises_without_cuda(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call(_paper_jobs(JobSpec))


def test_quickstart_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(profiling, "_ENABLED", profiling.enabled())  # main() turns it on
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "SR (Gittins)      : 10.0000" in out
    assert "SERPT             : 9.7500" in out
    assert "OPTIMAL [0 1]   : 9.1000" in out
    assert "prof.sojourn_eval.static.enum.cpu" in out
