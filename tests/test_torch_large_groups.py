"""Job groups past the int64 outcome count and the dynamic kernel's
register templates, against the reference on the CPU.

* The combination count K of 63 or more two-stage jobs is at least 2**63.
  The port counts it with Python integers, so ``evaluate_many`` takes the
  streamed Monte-Carlo tier there.  The reference counts it in int64,
  which wraps, and raises ``OverflowError`` (ROADMAP, R6).  So the port
  is held to the reference's ``evaluate(jobs, policy, samples=(seed,
  S))`` with the seed that ``evaluate_many`` draws from the same
  generator; at N = 62 the count does not wrap and the two
  ``evaluate_many`` agree directly.
* SR and SERPT over more than 64 jobs (the CUDA kernel holds tables of
  up to 256 (job, stage) entries in registers and larger ones in shared
  memory or device scratch, which ``chip_smoke.py`` holds against the
  plain version).  Here the plain versions run against the reference's
  XLA paths.

The reference's evaluator enters float64 through the removed
``jax.experimental.enable_x64`` (ROADMAP, R1); ``ref_x64`` aliases it
for one test at a time.  Tolerance 1e-9 relative.
"""

import math

import jax
import numpy as np
import pytest

from repro.core import evaluator as ref_ev
from repro.core import jobs as ref_jobs
from repro.kernels.sojourn_eval import dynamic as ref_dynamic
from repro_torch.core import evaluator as ev
from repro_torch.core import policies
from repro_torch.core.jobs import from_reference
from repro_torch.kernels.sojourn_eval import dynamic as D
from repro_torch.kernels.sojourn_eval import rng as kernel_rng

RTOL = 1e-9
MC_SAMPLES = 2048


@pytest.fixture
def ref_x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _workload(n, m=2, seed=None):
    return ref_jobs.generate_workload(np.random.default_rng(n if seed is None else seed), n, m, 1)


def test_count_is_exact_past_int64():
    for n in (62, 63, 64, 80):
        jobs = from_reference(_workload(n))
        assert ev.exact_combination_count(jobs) == 2**n
    mixed = from_reference(_workload(70, 3))
    assert ev.exact_combination_count(mixed) == 3**70


@pytest.mark.parametrize("n", [63, 64, 80])
def test_evaluate_many_streams_past_int64(ref_x64, n):
    """N >= 63 two-stage jobs: the streamed tier, equal to the reference's
    ``samples=`` path under the seed ``evaluate_many`` draws first."""
    ref = _workload(n)
    got = ev.evaluate_many(from_reference(ref), ("rank",), np.random.default_rng(7),
                           mc_samples=MC_SAMPLES, device="cpu")
    seed = int(np.random.default_rng(7).integers(0, kernel_rng.MAX_SEED))
    want = ref_ev.evaluate(ref, "rank", samples=(seed, MC_SAMPLES))
    assert math.isfinite(got["rank"]) and _rel(got["rank"], want) <= RTOL


def test_evaluate_many_at_62_matches_reference(ref_x64):
    """N = 62: the count does not wrap, and both packages stream."""
    ref = _workload(62)
    want = ref_ev.evaluate_many(ref, ("rank", "random"), np.random.default_rng(3),
                                mc_samples=MC_SAMPLES)
    got = ev.evaluate_many(from_reference(ref), ("rank", "random"), np.random.default_rng(3),
                           mc_samples=MC_SAMPLES, device="cpu")
    for alg in want:
        assert _rel(got[alg], want[alg]) <= RTOL, alg


def test_exact_tier_still_refuses_past_the_cap():
    jobs = from_reference(_workload(63))
    with pytest.raises(ValueError, match="MAX_EXACT_COMBOS"):
        ev.expected_sojourn_static(jobs, np.arange(63), device="cpu")
    with pytest.raises(ValueError, match="MAX_EXACT_COMBOS"):
        ev.expected_sojourn_dynamic(jobs, "sr", device="cpu")
    with pytest.raises(ValueError, match="materialize|MAX_MATERIALIZED"):
        ev.enumerate_outcomes(jobs)


@pytest.mark.parametrize("n", [65, 80])
@pytest.mark.parametrize("policy", ["sr", "serpt"])
def test_dynamic_past_64_jobs_matches_reference(ref_x64, n, policy):
    ref = _workload(n)
    want = ref_ev.expected_sojourn_dynamic(ref, policy, samples=(1, MC_SAMPLES))
    got = ev.expected_sojourn_dynamic(from_reference(ref), policy, samples=(1, MC_SAMPLES),
                                      device="cpu")
    assert _rel(got, want) <= RTOL


def test_dynamic_past_64_jobs_on_servers_matches_reference():
    """The op on W = 3 servers, SR and SERPT at once, exact over a group
    of 72 jobs of which 11 have two stages (K = 2**11)."""
    rng = np.random.default_rng(72)
    ref = []
    for i in range(72):
        first = float(rng.uniform(0.5, 3))
        two = i % 7 == 0
        ref.append(ref_jobs.JobSpec(sizes=[first, first + 2.0] if two else [first],
                                    probs=[0.4, 0.6] if two else [1.0], job_id=i))
    jobs = from_reference(ref)
    _, probs, num_stages = policies.padded_arrays(jobs)
    assert math.prod(int(m) for m in num_stages) == 2**11
    tables = np.stack([policies.index_table(jobs, p) for p in ("sr", "serpt")])
    inputs = (probs, policies.stage_durations(jobs), num_stages, tables)
    with jax.enable_x64(True):
        want = ref_dynamic.sojourn_eval_dynamic(*inputs, n_servers=3, impl="xla")
    got = D.sojourn_eval_dynamic(*inputs, n_servers=3, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)


def test_dynamic_past_64_jobs_with_infinite_index_as_reference():
    """ROADMAP R2 at N = 66: a job that never succeeds has rank index
    +inf and is never seated on the fused paths, both packages'."""
    ref = _workload(66, seed=5)
    ref[9] = ref_jobs.JobSpec(sizes=[1.0, 3.0], probs=[1.0, 0.0], job_id=ref[9].job_id)
    jobs = from_reference(ref)
    _, probs, num_stages = policies.padded_arrays(jobs)
    table = policies.index_table(jobs, "rank")
    assert np.isinf(table).any()
    inputs = (probs, policies.stage_durations(jobs), num_stages, table)
    with jax.enable_x64(True):
        want = ref_dynamic.sojourn_eval_dynamic(*inputs, samples=(11, 1024), impl="xla")
    got = D.sojourn_eval_dynamic(*inputs, samples=(11, 1024), device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)


def test_scratch_path_sizing():
    """The kernel holds REGISTER_WORDS queue-mask words (N M <= 256) and
    REGISTER_SERVERS servers in registers, then a block's state in up to
    SHARED_STATE_BYTES of shared memory; only past that does the wrapper
    hand it scratch, 16 bytes a mask word and server slot for each thread
    of a grid cut to SCRATCH_BLOCKS blocks."""
    from repro_torch.kernels.sojourn_eval import kernel as K

    assert (D.REGISTER_WORDS, D.REGISTER_SERVERS, D.SHARED_STATE_BYTES) == (4, 8, 96 << 10)
    assert D.mask_words(128, 2) == 4 and D.mask_words(129, 2) == 5
    assert D._scratch_per_thread(80, 2, 1) == 0  # registers: phase 3b's group
    assert D._scratch_per_thread(65, 2, 2) == 0
    assert D._scratch_per_thread(160, 2, 1) == 0  # shared memory: 6 words, 1 slot
    assert D._scratch_per_thread(736, 2, 1) == 0  # 24 words and slots: 96 KB a block
    assert D._scratch_per_thread(737, 2, 1) == 25 * D.STATE_BYTES == 400
    assert K.blocks_per_order(1 << 20, 2, K.SCRATCH_BLOCKS) == K.SCRATCH_BLOCKS // 2
    assert K.blocks_per_order(1 << 20, 2) == K.TARGET_BLOCKS // 2
    assert K.blocks_per_order(300, 1, K.SCRATCH_BLOCKS) == 2  # at most one index a thread
