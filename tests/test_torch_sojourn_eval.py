"""Port parity of the static-order op and its kernels' plain versions.

The same inputs, made with NumPy from a seed, go through the JAX
package's ``ops.sojourn_eval`` (under ``jax.enable_x64``: the XLA path,
plus the Pallas kernels in interpret mode at N <= 5) and the port's
``sojourn_eval(device="cpu")``, which runs the plain PyTorch versions of
``sojourn_enum`` / ``sojourn_mc``.  Tolerance: 1e-9 relative, the JAX
package's own bar for float64 sums taken in another order.  The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from repro.core import jobs as ref_jobs
from repro.kernels.sojourn_eval import ops as ref_ops
from repro.kernels.sojourn_eval import ref as ref_ref
from repro_torch.core import policies
from repro_torch.core.jobs import JobSpec, from_reference
from repro_torch.kernels.sojourn_eval import kernel as K
from repro_torch.kernels.sojourn_eval import ops, ref

RTOL = 1e-9
SEED = 0x5EED_CAFE


def _relerr(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _workload(n, m, seed=0, workload_set=1):
    jobs = ref_jobs.generate_workload(np.random.default_rng(seed), n, m, workload_set)
    return jobs, from_reference(jobs)


def _orders(n, rng, p=5):
    perms = np.array(list(itertools.permutations(range(n))), dtype=np.int32)
    return perms[rng.choice(len(perms), size=min(p, len(perms)), replace=False)]


def _reference(jobs, orders, samples=None, impl="xla"):
    sizes, probs, num_stages = policies.padded_arrays(jobs)
    with jax.enable_x64(True):
        return ref_ops.sojourn_eval(sizes, probs, num_stages, orders, samples=samples,
                                    impl=impl)


def _port(jobs, orders, samples=None):
    sizes, probs, num_stages = policies.padded_arrays(jobs)
    return ops.sojourn_eval(sizes, probs, num_stages, orders, samples=samples, device="cpu")


def _assert_close(got, want):
    for g, w in zip(got, want):
        assert _relerr(g, w) <= RTOL, (g, w)


@pytest.mark.parametrize("n,m", [(1, 1), (1, 3), (4, 1), (4, 2), (4, 3), (7, 2), (7, 3)])
def test_enum_matches_reference(n, m):
    ref_w, port_w = _workload(n, m, seed=n * 10 + m)
    orders = _orders(n, np.random.default_rng(n + m))
    _assert_close(_port(port_w, orders), _reference(ref_w, orders))


@pytest.mark.parametrize("n,m", [(1, 2), (4, 1), (4, 3), (7, 2), (7, 3)])
def test_mc_matches_reference(n, m):
    ref_w, port_w = _workload(n, m, seed=n * 10 + m + 1)
    orders = _orders(n, np.random.default_rng(n))
    samples = (SEED, 3000)  # not a multiple of any tile: a ragged tail
    _assert_close(_port(port_w, orders, samples), _reference(ref_w, orders, samples))


@pytest.mark.parametrize("samples", [None, (SEED, 1500)])
def test_matches_reference_pallas_interpret(samples):
    ref_w, port_w = _workload(4, 2, seed=3)
    orders = _orders(4, np.random.default_rng(1), p=3)
    _assert_close(_port(port_w, orders, samples),
                  _reference(ref_w, orders, samples, impl="interpret"))


def test_ragged_stage_counts_match_reference():
    ref_w = [
        ref_jobs.JobSpec(sizes=[1.0], probs=[1.0], job_id=0),
        ref_jobs.JobSpec(sizes=[0.5, 2.0, 4.0], probs=[0.2, 0.3, 0.5], job_id=1),
        ref_jobs.JobSpec(sizes=[1.5, 3.0], probs=[0.6, 0.4], job_id=2),
    ]
    port_w = from_reference(ref_w)
    orders = np.array(list(itertools.permutations(range(3))), dtype=np.int32)
    _assert_close(_port(port_w, orders), _reference(ref_w, orders))
    _assert_close(_port(port_w, orders, (SEED, 2000)), _reference(ref_w, orders, (SEED, 2000)))


@pytest.mark.parametrize("samples", [None, (SEED, 777)])
def test_plain_tiles_and_order_batches(monkeypatch, samples):
    """Many ragged plain tiles and many order batches give the one-shot values."""
    _, port_w = _workload(6, 2, seed=8)
    orders = _orders(6, np.random.default_rng(2), p=7)
    want = _port(port_w, orders, samples)
    monkeypatch.setattr(K, "_plain_tile", lambda width: 37)
    monkeypatch.setattr(ops, "_order_batch", lambda n_orders, tile, n: 3)
    _assert_close(_port(port_w, orders, samples), want)


def test_enum_plain_matches_dense_oracles():
    ref_w, port_w = _workload(5, 3, seed=4)
    sizes, probs, num_stages = policies.padded_arrays(port_w)
    orders = _orders(5, np.random.default_rng(4))
    with jax.enable_x64(True):
        want = [np.asarray(w) for w in ref_ref.ref_sojourn(sizes, probs, num_stages, orders)]
    oracle = [t.numpy() for t in ref.ref_sojourn(sizes, probs, num_stages, orders)]
    _assert_close(oracle, want)
    _assert_close(_port(port_w, orders), oracle)


def test_mc_plain_matches_replayed_table():
    """The streamed plain path decodes exactly the host replay's outcomes."""
    _, port_w = _workload(5, 3, seed=6)
    sizes, probs, num_stages = policies.padded_arrays(port_w)
    orders = _orders(5, np.random.default_rng(6))
    outcomes, weights = ref.ref_mc_outcomes(probs, num_stages, SEED, 2500)
    want = [t.numpy() for t in ref.ref_sojourn(sizes, probs, num_stages, orders,
                                                outcomes, weights)]
    _assert_close(_port(port_w, orders, (SEED, 2500)), want)


def test_mixed_radix_strides_match_reference():
    num_stages = np.array([2, 3, 2, 4])
    np.testing.assert_array_equal(ref.mixed_radix_strides(num_stages),
                                  ref_ref.mixed_radix_strides(num_stages))
    np.testing.assert_array_equal(ref.ref_decode(num_stages, 48),
                                  ref_ref.ref_decode(num_stages, 48))


@pytest.mark.parametrize("kwargs", [
    {"outcomes": np.zeros((2, 2), np.int32), "weights": np.full(2, 0.5)},
    {"weights": np.ones(1)},
])
def test_explicit_outcome_tables_not_ported(kwargs):
    """The explicit-table mode, once left for a later slice, is ported: a
    table evaluates as the dense oracle does, and weights alone raise."""
    jobs = [JobSpec(sizes=[1.0, 2.0], probs=[0.5, 0.5]), JobSpec(sizes=[1.0], probs=[1.0])]
    sizes, probs, num_stages = policies.padded_arrays(jobs)
    orders = np.array([[0, 1]])
    if "outcomes" not in kwargs:
        with pytest.raises(ValueError, match="need weights"):
            ops.sojourn_eval(sizes, probs, num_stages, orders, device="cpu", **kwargs)
        return
    want = [t.numpy() for t in ref.ref_sojourn(sizes, probs, num_stages, orders, **kwargs)]
    _assert_close(ops.sojourn_eval(sizes, probs, num_stages, orders, device="cpu", **kwargs),
                  want)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port_w = _workload(3, 2)
    sizes, probs, num_stages = policies.padded_arrays(port_w)
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.sojourn_eval(sizes, probs, num_stages, np.array([[0, 1, 2]]))


def _enum_args():
    _, port_w = _workload(3, 2, seed=1)
    sizes, probs, num_stages = policies.padded_arrays(port_w)
    strides = ref.mixed_radix_strides(num_stages).astype(np.int32)
    args = ops.permuted_inputs([sizes, probs, strides, num_stages.astype(np.int32)],
                               np.array([[0, 1, 2], [2, 1, 0]]), "cpu")
    return args, int(np.prod(num_stages))


@pytest.mark.parametrize("bad,exc", [
    (lambda a: [a[0].float(), *a[1:]], TypeError),  # float32 sizes
    (lambda a: [a[0], a[1], a[2].long(), a[3]], TypeError),  # int64 strides
    (lambda a: [a[0][:1], *a[1:]], ValueError),  # order count mismatch
    (lambda a: [a[0].transpose(1, 2).contiguous().transpose(1, 2), *a[1:]], ValueError),
    (lambda a: [a[0].to("meta"), *a[1:]], ValueError),  # mixed devices
])
def test_wrapper_rejects_bad_inputs(bad, exc):
    args, k_total = _enum_args()
    with pytest.raises(exc):
        K.sojourn_enum(*bad(args), k_total)


def test_wrapper_never_falls_back_off_the_cpu():
    """A tensor on a device without a kernel raises instead of running the
    plain version."""
    args, k_total = _enum_args()
    with pytest.raises(ValueError, match="CUDA"):
        K.sojourn_enum(*[a.to("meta") for a in args], k_total)
    with pytest.raises(ValueError):
        K.sojourn_enum(*args, 0)
    assert K.launches == {"sojourn_enum": 0, "sojourn_mc": 0, "sojourn_outcomes": 0}
