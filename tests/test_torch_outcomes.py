"""Port parity of the explicit-outcome tier: ``sojourn_outcomes`` and the
materialized evaluator paths around it.

The same tables, made with NumPy from a seed (or by the reference's own
``enumerate_outcomes`` / ``sample_outcomes`` from an identical
``np.random.Generator``), go through the JAX package under
``jax.enable_x64`` and through the port on the CPU, which runs the
kernel's plain version ``sojourn_outcomes_torch``.  The reference's
``evaluator`` is reached through the test-scoped ``enable_x64`` alias
(ROADMAP fault R1).  Tolerance: 1e-9 relative, float64 sums in another
order.  The CUDA kernel is held against the plain version on the card by
``chip_smoke.py``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import evaluator as ref_ev
from repro.core import jobs as ref_jobs
from repro.kernels.sojourn_eval import ops as ref_ops
from repro.kernels.sojourn_eval import ref as ref_ref
from repro_torch.core import evaluator as ev
from repro_torch.core import policies
from repro_torch.core.jobs import from_reference
from repro_torch.kernels.sojourn_eval import kernel as K
from repro_torch.kernels.sojourn_eval import ops, ref

RTOL = 1e-9


@pytest.fixture
def ref_x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _relerr(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _assert_close(got, want):
    for g, w in zip(got, want):
        assert _relerr(g, w) <= RTOL, (g, w)


def _workload(n, m, seed=0, workload_set=1):
    jobs = ref_jobs.generate_workload(np.random.default_rng(seed), n, m, workload_set)
    return jobs, from_reference(jobs)


def _orders(n, rng, p=5):
    perms = np.array(list(itertools.permutations(range(n))), dtype=np.int32)
    return perms[rng.choice(len(perms), size=min(p, len(perms)), replace=False)]


def _table(jobs, n_rows, seed):
    """A random valid outcome table with Dirichlet weights, one of them 0."""
    _, _, num_stages = policies.padded_arrays(jobs)
    rng = np.random.default_rng(seed)
    outcomes = (rng.random((n_rows, len(num_stages))) * num_stages).astype(np.int32)
    weights = rng.dirichlet(np.ones(n_rows))
    weights[n_rows // 2] = 0.0  # a zero-weight row
    return outcomes, weights


def _reference(jobs, orders, outcomes, weights, impl):
    sizes, probs, num_stages = policies.padded_arrays(jobs)
    with jax.enable_x64(True):
        return ref_ops.sojourn_eval(sizes, probs, num_stages, orders, outcomes=outcomes,
                                    weights=weights, impl=impl)


def _port(jobs, orders, outcomes, weights):
    sizes, probs, num_stages = policies.padded_arrays(jobs)
    return ops.sojourn_eval(sizes, probs, num_stages, orders, outcomes=outcomes,
                            weights=weights, device="cpu")


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("n,m,rows", [(1, 1, 5), (1, 3, 1029), (4, 2, 1024), (5, 3, 3001)])
def test_outcomes_match_reference(impl, n, m, rows):
    """Tail tiles (K not a multiple of the reference's 1024-row tiles),
    N = 1, a zero-weight row."""
    ref_w, port_w = _workload(n, m, seed=n * 10 + m)
    orders = _orders(n, np.random.default_rng(n + m))
    outcomes, weights = _table(port_w, rows, seed=rows)
    _assert_close(_port(port_w, orders, outcomes, weights),
                  _reference(ref_w, orders, outcomes, weights, impl))


def test_enumerated_table_equals_exact_enumeration():
    ref_w, port_w = _workload(6, 3, seed=2)
    orders = _orders(6, np.random.default_rng(0))
    outcomes, weights = ev.enumerate_outcomes(port_w)
    sizes, probs, num_stages = policies.padded_arrays(port_w)
    exact = ops.sojourn_eval(sizes, probs, num_stages, orders, device="cpu")
    _assert_close(_port(port_w, orders, outcomes, weights), exact)
    _assert_close(_port(port_w, orders, outcomes, weights),
                  _reference(ref_w, orders, outcomes, weights, "xla"))


@pytest.mark.parametrize("n,m,workload_set", [(5, 2, 1), (4, 3, 4), (7, 2, 5)])
def test_enumerate_outcomes_identical(ref_x64, n, m, workload_set):
    ref_w, port_w = _workload(n, m, seed=n + m, workload_set=workload_set)
    want = ref_ev.enumerate_outcomes(ref_w)
    got = ev.enumerate_outcomes(port_w)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype == np.int32
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n,m,samples", [(5, 2, 1000), (4, 3, 2500), (1, 2, 7)])
def test_sample_outcomes_identical(n, m, samples):
    ref_w, port_w = _workload(n, m, seed=n * m)
    r_ref, r_port = np.random.default_rng(11), np.random.default_rng(11)
    want = ref_ev.sample_outcomes(ref_w, samples, r_ref)
    got = ev.sample_outcomes(port_w, samples, r_port)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert r_ref.random() == r_port.random()  # the generators moved alike


def test_materialized_cap_raises():
    _, port_w = _workload(22, 2, seed=1)
    with pytest.raises(ValueError, match="MAX_MATERIALIZED_COMBOS"):
        ev.enumerate_outcomes(port_w)


def test_realized_arrays_identical():
    ref_w, port_w = _workload(5, 3, seed=9)
    outcomes, _ = ev.enumerate_outcomes(port_w)
    for g, w in zip(ev._realized_arrays(port_w, outcomes),
                    ref_ev._realized_arrays(ref_w, outcomes)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("also_all_jobs", [False, True])
def test_static_batch_matches_reference(also_all_jobs):
    ref_w, port_w = _workload(5, 3, seed=4)
    outcomes, weights = ev.sample_outcomes(port_w, 2000, np.random.default_rng(4))
    durations, success = ev._realized_arrays(port_w, outcomes)
    orders = _orders(5, np.random.default_rng(5))
    with jax.enable_x64(True):
        want = ref_ev._static_batch(jnp.asarray(durations), jnp.asarray(success),
                                    jnp.asarray(weights), jnp.asarray(orders),
                                    also_all_jobs=also_all_jobs)
    got = ev._static_batch(torch.as_tensor(durations), torch.as_tensor(success),
                           torch.as_tensor(weights), torch.as_tensor(orders),
                           also_all_jobs=also_all_jobs)
    if not also_all_jobs:
        want, got = (want,), (got,)
    _assert_close([g.numpy() for g in got], [np.asarray(w) for w in want])
    # and the seed path agrees with the fused op over the same table
    fused = _port(port_w, orders, outcomes, weights)
    _assert_close(fused[: len(got)], [g.numpy() for g in got])


@pytest.mark.parametrize("policy", ["sr", "serpt", "rank"])
def test_dynamic_batch_matches_reference(policy):
    ref_w, port_w = _workload(5, 2, seed=6)
    outcomes, weights = ev.enumerate_outcomes(port_w)
    _, success = ev._realized_arrays(port_w, outcomes)
    idx = policies.index_table(port_w, policy)
    durs = policies.stage_durations(port_w)
    total = int(policies.padded_arrays(port_w)[2].sum())
    with jax.enable_x64(True):
        want = ref_ev._dynamic_batch(jnp.asarray(np.float64(idx)), jnp.asarray(np.float64(durs)),
                                     jnp.asarray(outcomes), jnp.asarray(success),
                                     jnp.asarray(weights), total)
    got = ev._dynamic_batch(torch.as_tensor(np.float64(idx)), torch.as_tensor(np.float64(durs)),
                            torch.as_tensor(outcomes), torch.as_tensor(success),
                            torch.as_tensor(weights), total)
    assert _relerr(float(got), float(want)) <= RTOL


def test_dynamic_batch_with_infinite_index_as_reference():
    """Fault R2: a zero-success-probability job under the rank table has
    index +inf; the lockstep tier must behave as the reference's does."""
    ref_w = [
        ref_jobs.JobSpec(sizes=[1.0, 2.0], probs=[1.0, 0.0], job_id=0),
        ref_jobs.JobSpec(sizes=[0.5, 1.5], probs=[0.4, 0.6], job_id=1),
        ref_jobs.JobSpec(sizes=[1.0, 3.0], probs=[0.3, 0.7], job_id=2),
    ]
    port_w = from_reference(ref_w)
    outcomes, weights = ev.enumerate_outcomes(port_w)
    _, success = ev._realized_arrays(port_w, outcomes)
    idx = policies.index_table(port_w, "rank")
    assert np.isinf(idx).any()
    durs = policies.stage_durations(port_w)
    with jax.enable_x64(True):
        want = ref_ev._dynamic_batch(jnp.asarray(np.float64(idx)), jnp.asarray(np.float64(durs)),
                                     jnp.asarray(outcomes), jnp.asarray(success),
                                     jnp.asarray(weights), 6)
    got = ev._dynamic_batch(torch.as_tensor(np.float64(idx)), torch.as_tensor(np.float64(durs)),
                            torch.as_tensor(outcomes), torch.as_tensor(success),
                            torch.as_tensor(weights), 6)
    assert _relerr(float(got), float(want)) <= RTOL


def test_expected_sojourn_with_tables_matches_reference(ref_x64):
    ref_w, port_w = _workload(6, 2, seed=12)
    orders = _orders(6, np.random.default_rng(12))
    for make in (lambda w: ev.enumerate_outcomes(w),
                 lambda w: ev.sample_outcomes(w, 3000, np.random.default_rng(3))):
        outcomes, weights = make(port_w)
        want = ref_ev.expected_sojourn_static(ref_w, orders, outcomes, weights,
                                              also_all_jobs=True)
        got = ev.expected_sojourn_static(port_w, orders, outcomes, weights,
                                         also_all_jobs=True, device="cpu")
        _assert_close(got, want)
        for policy in ("sr", "serpt"):
            want = ref_ev.expected_sojourn_dynamic(ref_w, policy, outcomes, weights)
            got = ev.expected_sojourn_dynamic(port_w, policy, outcomes, weights, device="cpu")
            assert _relerr(got, want) <= RTOL, policy
        for policy in ("rank", "sr"):
            want = ref_ev.evaluate(ref_w, policy, outcomes=outcomes, weights=weights)
            got = ev.evaluate(port_w, policy, outcomes=outcomes, weights=weights, device="cpu")
            assert _relerr(got, want) <= RTOL, policy


def test_dynamic_table_tier_is_single_server():
    _, port_w = _workload(4, 2, seed=1)
    outcomes, weights = ev.enumerate_outcomes(port_w)
    with pytest.raises(ValueError, match="single-server"):
        ev.expected_sojourn_dynamic(port_w, "sr", outcomes, weights, n_servers=2,
                                    device="cpu")


def test_dense_oracles_with_tables_match_reference():
    _, port_w = _workload(4, 3, seed=7)
    sizes, probs, num_stages = policies.padded_arrays(port_w)
    outcomes, weights = _table(port_w, 500, seed=7)
    orders = _orders(4, np.random.default_rng(7))
    with jax.enable_x64(True):
        want = [np.asarray(w) for w in ref_ref.ref_sojourn(sizes, probs, num_stages, orders,
                                                           outcomes, weights)]
    got = [t.numpy() for t in ref.ref_sojourn(sizes, probs, num_stages, orders,
                                              outcomes, weights)]
    _assert_close(got, want)
    _assert_close(_port(port_w, orders, outcomes, weights), got)
    idx, durs = policies.index_table(port_w, "sr"), policies.stage_durations(port_w)
    want = ref_ref.ref_sojourn_dynamic(probs, durs, num_stages, idx, outcomes, weights)
    got = ref.ref_sojourn_dynamic(probs, durs, num_stages, idx, outcomes, weights)
    _assert_close(got, want)


def test_plain_tiles_and_order_batches(monkeypatch):
    _, port_w = _workload(6, 2, seed=8)
    orders = _orders(6, np.random.default_rng(2), p=19)
    outcomes, weights = _table(port_w, 1111, seed=8)
    want = _port(port_w, orders, outcomes, weights)
    monkeypatch.setattr(K, "_plain_tile", lambda width: 37)
    monkeypatch.setattr(ops, "_order_batch", lambda n_orders, tile, n: 3)
    _assert_close(_port(port_w, orders, outcomes, weights), want)


@pytest.mark.parametrize("kwargs,match", [
    ({"outcomes": np.zeros((3, 2), np.int32)}, "need weights"),
    ({"weights": np.ones(3)}, "need weights"),
    ({"outcomes": np.zeros((3, 3), np.int32), "weights": np.ones(3)}, r"\(K, 2\)"),
    ({"outcomes": np.zeros((3, 2), np.int32), "weights": np.ones(2)}, r"\(3,\)"),
    ({"outcomes": np.array([[0, 1]], np.int32), "weights": np.ones(1)}, "stage index"),
    ({"outcomes": np.zeros((1, 2), np.int32), "weights": np.ones(1),
      "samples": (1, 10)}, "mutually exclusive"),
])
def test_op_rejects_bad_tables(kwargs, match):
    jobs = from_reference([ref_jobs.JobSpec(sizes=[1.0, 2.0], probs=[0.5, 0.5]),
                           ref_jobs.JobSpec(sizes=[1.0], probs=[1.0])])
    sizes, probs, num_stages = policies.padded_arrays(jobs)
    with pytest.raises(ValueError, match=match):
        ops.sojourn_eval(sizes, probs, num_stages, np.array([[0, 1]]), device="cpu", **kwargs)


def _kernel_args():
    _, port_w = _workload(3, 2, seed=1)
    sizes, _, num_stages = policies.padded_arrays(port_w)
    outcomes, weights = _table(port_w, 40, seed=1)
    tables = ops.outcome_tables(outcomes, weights, num_stages, "cpu")
    return list(ops.outcomes_kernel_args(sizes, num_stages, np.array([[0, 1, 2], [2, 1, 0]]),
                                         tables, "cpu"))


@pytest.mark.parametrize("bad,exc", [
    (lambda a: [a[0].float(), *a[1:]], TypeError),  # float32 sizes
    (lambda a: [a[0], a[1].long(), *a[2:]], TypeError),  # int64 radix
    (lambda a: [*a[:3], a[3][:5], a[4]], ValueError),  # table/weights length mismatch
    (lambda a: [*a[:3], a[3].T.contiguous().T, a[4]], ValueError),  # job-major table
    (lambda a: [*a[:4], a[4].to("meta")], ValueError),  # mixed devices
])
def test_wrapper_rejects_bad_inputs(bad, exc):
    with pytest.raises(exc):
        K.sojourn_outcomes(*bad(_kernel_args()))


def test_wrapper_never_falls_back_off_the_cpu():
    args = _kernel_args()
    with pytest.raises(ValueError, match="CUDA"):
        K.sojourn_outcomes(*[a.to("meta") for a in args])
    assert K.launches["sojourn_outcomes"] == 0
