"""Port parity of the dynamic-policy op and its kernels' plain versions.

SR and SERPT index tables on W in {1, 2, 3} servers go through the JAX
package's ``sojourn_eval_dynamic`` (under ``jax.enable_x64``: the XLA
path, plus the Pallas kernels in interpret mode at N <= 5) and the
port's ``sojourn_eval_dynamic(device="cpu")``, which runs the plain
lockstep versions of ``dynamic_sojourn_enum`` / ``dynamic_sojourn_mc``.
Tolerance: 1e-9 relative (float64 sums in another order).  The
workloads have no zero-success jobs, whose ``+inf`` rank index the
reference paths disagree on (ROADMAP, fault R2); SR and SERPT tables are
finite.
"""

import jax
import numpy as np
import pytest

from repro.core import jobs as ref_jobs
from repro.kernels.sojourn_eval import dynamic as ref_dynamic
from repro.kernels.sojourn_eval import ref as ref_ref
from repro_torch.core import policies
from repro_torch.core.jobs import from_reference
from repro_torch.kernels.sojourn_eval import dynamic as D
from repro_torch.kernels.sojourn_eval import ops, ref

RTOL = 1e-9
SEED = 0x5EED_CAFE
POLICIES = ("sr", "serpt")


def _relerr(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _assert_close(got, want):
    for g, w in zip(got, want):
        assert _relerr(g, w) <= RTOL, (g, w)


def _inputs(n, m, seed):
    jobs = from_reference(ref_jobs.generate_workload(np.random.default_rng(seed), n, m, 1))
    _, probs, num_stages = policies.padded_arrays(jobs)
    tables = np.stack([policies.index_table(jobs, p) for p in POLICIES])
    return probs, policies.stage_durations(jobs), num_stages, tables


def _reference(inputs, n_servers, samples=None, impl="xla"):
    with jax.enable_x64(True):
        return ref_dynamic.sojourn_eval_dynamic(
            *inputs, samples=samples, n_servers=n_servers, impl=impl
        )


def _port(inputs, n_servers, samples=None):
    return D.sojourn_eval_dynamic(*inputs, samples=samples, n_servers=n_servers,
                                  device="cpu")


@pytest.mark.parametrize("n,m,seed", [(1, 3, 0), (4, 3, 1), (6, 2, 2), (7, 2, 3)])
@pytest.mark.parametrize("n_servers", (1, 2, 3))
def test_enum_matches_reference(n, m, seed, n_servers):
    inputs = _inputs(n, m, seed)
    _assert_close(_port(inputs, n_servers), _reference(inputs, n_servers))


@pytest.mark.parametrize("n_servers", (1, 2, 3))
def test_mc_matches_reference(n_servers):
    inputs = _inputs(5, 3, 4)
    samples = (SEED, 3000)
    _assert_close(_port(inputs, n_servers, samples), _reference(inputs, n_servers, samples))


@pytest.mark.parametrize("samples", [None, (SEED, 1200)])
def test_matches_reference_pallas_interpret(samples):
    inputs = _inputs(4, 2, 5)
    _assert_close(_port(inputs, 2, samples), _reference(inputs, 2, samples, "interpret"))


@pytest.mark.parametrize("n_servers", (1, 2))
def test_enum_matches_dense_oracles(n_servers):
    """The plain path, the port's naive oracle and the reference's oracle agree."""
    probs, durs, num_stages, tables = _inputs(5, 2, 6)
    got = _port((probs, durs, num_stages, tables), n_servers)
    for p, table in enumerate(tables):
        want = ref_ref.ref_sojourn_dynamic(probs, durs, num_stages, table, n_servers=n_servers)
        oracle = ref.ref_sojourn_dynamic(probs, durs, num_stages, table, n_servers=n_servers)
        assert oracle == want
        _assert_close((got[0][p], got[1][p]), oracle)


def test_mc_plain_matches_replayed_table():
    probs, durs, num_stages, tables = _inputs(4, 3, 7)
    outcomes, weights = ref.ref_mc_outcomes(probs, num_stages, SEED, 400)
    got = _port((probs, durs, num_stages, tables), 2, (SEED, 400))
    for p, table in enumerate(tables):
        want = ref.ref_sojourn_dynamic(probs, durs, num_stages, table, outcomes, weights,
                                       n_servers=2)
        _assert_close((got[0][p], got[1][p]), want)


def test_ragged_stage_counts_match_reference():
    ref_w = [
        ref_jobs.JobSpec(sizes=[1.0], probs=[1.0], job_id=0),
        ref_jobs.JobSpec(sizes=[0.5, 2.0, 4.0], probs=[0.2, 0.3, 0.5], job_id=1),
        ref_jobs.JobSpec(sizes=[1.5, 3.0], probs=[0.6, 0.4], job_id=2),
        ref_jobs.JobSpec(sizes=[0.2, 0.9], probs=[0.1, 0.9], job_id=3),
    ]
    jobs = from_reference(ref_w)
    _, probs, num_stages = policies.padded_arrays(jobs)
    tables = np.stack([policies.index_table(jobs, p) for p in POLICIES])
    inputs = (probs, policies.stage_durations(jobs), num_stages, tables)
    for w in (1, 2):
        _assert_close(_port(inputs, w), _reference(inputs, w))
        _assert_close(_port(inputs, w, (SEED, 900)), _reference(inputs, w, (SEED, 900)))


def test_constant_index_table_is_static_order():
    """A fixed-priority table on one server serves jobs in index order."""
    jobs = from_reference(ref_jobs.generate_workload(np.random.default_rng(9), 6, 3, 1))
    sizes, probs, num_stages = policies.padded_arrays(jobs)
    table = np.broadcast_to(policies.rank_values(jobs)[:, None], probs.shape)
    dyn = D.sojourn_eval_dynamic(probs, policies.stage_durations(jobs), num_stages, table,
                                 device="cpu")
    stat = ops.sojourn_eval(sizes, probs, num_stages, policies.rank_order(jobs)[None],
                            device="cpu")
    _assert_close(dyn, stat)


@pytest.mark.parametrize("samples", [None, (SEED, 555)])
def test_plain_tiles(monkeypatch, samples):
    inputs = _inputs(6, 2, 10)
    want = _port(inputs, 2, samples)
    monkeypatch.setattr(D, "PLAIN_TILE", 29)
    _assert_close(_port(inputs, 2, samples), want)


def test_wrapper_rejects_bad_inputs():
    probs, durs, num_stages, tables = _inputs(3, 2, 11)
    with pytest.raises(ValueError, match="n_servers"):
        _port((probs, durs, num_stages, tables), 0)
    with pytest.raises(ValueError, match="idx_tables"):
        _port((probs, durs, num_stages, tables[:, :2]), 1)
    assert D.launches == {"dynamic_sojourn_enum": 0, "dynamic_sojourn_mc": 0}
