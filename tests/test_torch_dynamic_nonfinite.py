"""The dynamic op's plain version on tables with NaN and -inf indices.

The reference's two dynamic paths disagree on such tables (ROADMAP R7):
its Pallas kernel keeps a strict ``<`` running minimum from +inf, so a
-inf index is seated first and a NaN one never, while its XLA path seats
only a finite minimum.  The port's CUDA kernel ranks entries as the
Pallas kernel does (``dynamic.queue_tables``), and its plain version
``_sim_tile_torch`` now does too (ROADMAP P4).  So:

* the plain version (``sojourn_eval_dynamic(device="cpu")``) equals the
  reference's ``impl="interpret"`` (the Pallas kernel in interpret mode)
  within 1e-9 on NaN and -inf tables, exact and streamed, W = 1-3: the
  Queue 3 probe of ROADMAP P4 and seeded random tables;
* ``test_torch_dynamic_queue._model``, the kernel's step loop on
  ``queue_tables``, equals the plain version per combination on those
  tables;
* on finite and +inf tables the plain version still equals the XLA path.

The reference runs under ``jax.enable_x64(True)`` as a context manager
(ROADMAP R1); the global x64 flag is never set.
"""

import math

import jax
import numpy as np
import pytest
import torch

from repro.core import jobs as ref_jobs
from repro.kernels.sojourn_eval import dynamic as ref_dynamic
from repro_torch.core import policies
from repro_torch.core.jobs import from_reference
from repro_torch.kernels.sojourn_eval import dynamic as D
from test_torch_dynamic_queue import _combinations, _model, _tables

RTOL = 1e-9
SEED = 0x5EED_CAFE
NAN, INF = math.nan, math.inf
#: Samples of the streamed cases (the Pallas kernel in interpret mode).
MC_SAMPLES = 1 << 10


def _probe(x):
    """ROADMAP P4's probe: 3 two-stage jobs, job 1's stage-0 index ``x``."""
    probs = np.array([[0.3, 0.7], [0.5, 0.5], [0.2, 0.8]])
    durs = np.array([[1.0, 2.0], [1.5, 0.5], [2.0, 1.0]])
    table = np.array([[1.0, 2.0], [x, 3.0], [0.7, 0.2]])
    return probs, durs, np.array([2, 2, 2]), table[None]


def _random(kind, n=5, m=3, seed=21):
    """A seeded group's SR, SERPT and RANK tables, with entries of the
    first two (and a stage-0 entry of the third) set by ``kind``: "nonfinite"
    puts NaN and -inf entries in, "finite" leaves the tables as they are,
    and "inf" takes a RANK table with a +inf row (a job that never
    succeeds)."""
    ref = ref_jobs.generate_workload(np.random.default_rng(seed), n, m, 1)
    if kind == "inf":
        ref[2] = ref_jobs.JobSpec(sizes=[1.0, 3.0], probs=[1.0, 0.0], job_id=ref[2].job_id)
    jobs = from_reference(ref)
    _, probs, num_stages = policies.padded_arrays(jobs)
    tables = np.stack([policies.index_table(jobs, p) for p in ("sr", "serpt", "rank")])
    if kind == "nonfinite":
        rng = np.random.default_rng(seed)
        for p, value in ((0, NAN), (1, -INF)):
            for j in rng.choice(n, size=2, replace=False):
                tables[p, j, rng.integers(0, num_stages[j])] = value
        tables[2, 0, 0], tables[2, 3, 0] = -INF, NAN
        assert np.isnan(tables).any() and np.isneginf(tables).any()
    elif kind == "inf":
        assert np.isposinf(tables).any()
    return probs, policies.stage_durations(jobs), num_stages, tables


NONFINITE = {"probe-nan": lambda: _probe(NAN), "probe-neginf": lambda: _probe(-INF),
             "random": lambda: _random("nonfinite")}
FINITE = {"probe-posinf": lambda: _probe(INF), "random-finite": lambda: _random("finite"),
          "random-posinf": lambda: _random("inf")}


def _reference(inputs, w, samples, impl):
    with jax.enable_x64(True):
        return ref_dynamic.sojourn_eval_dynamic(*inputs, samples=samples, n_servers=w,
                                                impl=impl)


def _assert_close(got, want):
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=0)


@pytest.mark.parametrize("mc", [False, True], ids=["enum", "mc"])
@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(NONFINITE))
def test_plain_matches_pallas_on_nonfinite_tables(case, w, mc):
    inputs = NONFINITE[case]()
    samples = (SEED, MC_SAMPLES) if mc else None
    got = D.sojourn_eval_dynamic(*inputs, samples=samples, n_servers=w, device="cpu")
    _assert_close(got, _reference(inputs, w, samples, "interpret"))
    if case.startswith("probe") and not mc:  # the split the repair closed
        xla = _reference(inputs, w, samples, "xla")
        assert xla[0][0] == 0.0 and got[0][0] > 0.0


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(NONFINITE))
def test_model_matches_plain_on_nonfinite_tables(case, w):
    _, durs, num_stages, tables = NONFINITE[case]()
    total = int(num_stages.sum())
    s = _combinations(num_stages)
    succ = s == num_stages[None, :] - 1
    for table in tables:
        tot, tsum, cnt = D._sim_tile_torch(torch.tensor(s), torch.tensor(succ),
                                           torch.tensor(table), torch.tensor(durs),
                                           total_stages=total, n_servers=w)
        model = _tables(table, durs, num_stages)
        got = [_model(row, model, w, total) for row in s.tolist()]
        assert [g[0] for g in got] == tot.tolist()
        assert [g[1] for g in got] == tsum.tolist()
        assert [g[2] for g in got] == cnt.tolist()


@pytest.mark.parametrize("mc", [False, True], ids=["enum", "mc"])
@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(FINITE))
def test_plain_matches_xla_on_finite_and_posinf_tables(case, w, mc):
    inputs = FINITE[case]()
    samples = (SEED, MC_SAMPLES) if mc else None
    got = D.sojourn_eval_dynamic(*inputs, samples=samples, n_servers=w, device="cpu")
    _assert_close(got, _reference(inputs, w, samples, "xla"))
