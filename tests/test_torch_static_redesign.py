"""The redesigned ``sojourn_outcomes`` and ``sojourn_mc`` kernels' designs on
the CPU, against the JAX package where it has a counterpart.

* The outcome tier at N = 200 (past the first outcome kernel's
  shared-memory limit, ROADMAP P5): the plain version against the
  reference's XLA path, and the (K, N) table reaching the wrapper without
  a copy (the kernel reads the evaluator's own layout).
* The card's order groups (``kernel.outcomes_plan``): phase 4's 17 orders
  at N = 27, M = 2 are one group, the plan's shared-memory count fits the
  card, and splitting the orders into groups of 1, 3 or all of them gives
  the same values to 1e-12.
* The Monte-Carlo kernel's integer decode (``kernel.mc_tables``): a model
  of the kernel's ``s0 + (bits > t_0) + ...`` on uint32 bits gives the
  stop stage of the plain version's ``u >= cdf`` count for random bits
  and at each threshold's edges, on CDFs with 0, 1, multiples of 2^-32, a
  cumsum just above 1 and NaN.
* The plain ``sojourn_mc`` at N = 1300 (past the first MC kernel's limit)
  against the reference.
* ``chip_smoke.THREEFRY_ALU_OPS``, the integer bound's count: a model of
  the kernel's ``.x``-only Threefry block (``threefry2x32_x``) equal to the
  stream's ``.x`` word, with 19 rotates and 19 xors.

Reference calls run under ``jax.enable_x64`` (ROADMAP R1).  Tolerance: 1e-9
relative against the reference (float64 sums in another order).
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import jobs as ref_jobs
from repro.kernels.sojourn_eval import ops as ref_ops
from repro_torch.core import evaluator as ev
from repro_torch.core import policies
from repro_torch.core.jobs import from_reference
from repro_torch.kernels.sojourn_eval import kernel as K
from repro_torch.kernels.sojourn_eval import ops, rng

RTOL = 1e-9
SEED = 0x5EED_CAFE
ROOT = Path(__file__).resolve().parents[1]


def _relerr(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _workload(n, m, seed):
    jobs = ref_jobs.generate_workload(np.random.default_rng(seed), n, m)
    return jobs, from_reference(jobs)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# sojourn_outcomes
# ---------------------------------------------------------------------------


def test_outcomes_at_n200_match_reference():
    ref_w, port_w = _workload(200, 2, seed=200)
    gen = np.random.default_rng(1)
    orders = np.stack([policies.rank_order(port_w)] + [gen.permutation(200) for _ in range(2)])
    outcomes, weights = ev.sample_outcomes(port_w, 300, np.random.default_rng(2))
    weights = weights.copy()
    weights[7] = 0.0  # a zero-weight row
    sizes, probs, num_stages = policies.padded_arrays(port_w)
    got = ops.sojourn_eval(sizes, probs, num_stages, orders, outcomes=outcomes,
                           weights=weights, device="cpu")
    with jax.enable_x64(True):
        want = ref_ops.sojourn_eval(sizes, probs, num_stages, orders, outcomes=outcomes,
                                    weights=weights, impl="xla")
    for g, w in zip(got, want):
        assert _relerr(g, w) <= RTOL
    # the table reaches the kernel's wrapper in its own (K, N) layout, uncopied
    table, w_t = ops.outcome_tables(outcomes, weights, num_stages, "cpu")
    assert table.shape == outcomes.shape and table.dtype == torch.int32
    assert np.shares_memory(table.numpy(), outcomes)
    args = ops.outcomes_kernel_args(sizes, num_stages, orders, (table, w_t), "cpu")
    assert args[3] is table


def test_outcome_table_range_check_on_its_device():
    _, port_w = _workload(4, 2, seed=3)
    _, _, num_stages = policies.padded_arrays(port_w)
    outcomes, weights = ev.enumerate_outcomes(port_w)
    for value in (-1, 2):
        bad = outcomes.copy()
        bad[3, 1] = value
        with pytest.raises(ValueError, match="stage index"):
            ops.outcome_tables(bad, weights, num_stages, "cpu")
        with pytest.raises(ValueError, match="stage index"):  # not int32: checked before
            ops.outcome_tables(bad.astype(np.int64), weights, num_stages, "cpu")


def test_card_groups_phase4_in_one():
    plan = K.outcomes_plan(27, 2, 17)
    assert plan.group == 17 and plan.rows == 256
    for n, m, p_orders in ((27, 2, 17), (21, 2, 1), (16, 4, 40), (192, 2, 40), (1, 2, 40320)):
        plan = K.outcomes_plan(n, m, p_orders)
        assert 1 <= plan.group <= p_orders and plan.split <= plan.group
        assert plan.rows // 2 * plan.split <= K.OUTCOMES_MAX_THREADS
        assert K.outcomes_smem_bytes(n, m, plan.rows, plan.stages, plan.group,
                                     plan.split) <= K.SMEM_BLOCK - 1024
    # past the tile's limits, the direct kernel (everything through L1)
    assert K.outcomes_plan(400, 2, 3).rows == 0
    assert K.outcomes_plan(4, K.OUTCOMES_MAX_M + 1, 3).rows == 0


@pytest.mark.parametrize("group", [1, 3, None])
def test_order_groups_agree(monkeypatch, group):
    _, port_w = _workload(9, 3, seed=9)
    gen = np.random.default_rng(9)
    orders = np.stack([gen.permutation(9) for _ in range(17)])
    outcomes, weights = ev.sample_outcomes(port_w, 2000, gen)
    sizes, probs, num_stages = policies.padded_arrays(port_w)

    def run():
        return ops.sojourn_eval(sizes, probs, num_stages, orders, outcomes=outcomes,
                                weights=weights, device="cpu")

    want = run()
    monkeypatch.setattr(ops, "_outcome_batch",
                        lambda dev, n_orders, k_total, n: group or n_orders)
    got = run()
    for g, w in zip(got, want):
        assert _relerr(g, w) <= 1e-12


# ---------------------------------------------------------------------------
# sojourn_mc
# ---------------------------------------------------------------------------


def _kernel_stages(recs, extra, bits):
    """The kernel's decode (``mc_stage``) on uint32 bits (S,) for every
    (order, position): ``s0 + (bits > t_0) + (bits > t_1) + ...``."""
    recs = recs.numpy().view(np.uint32).astype(np.int64)
    extra = extra.numpy().view(np.uint32).astype(np.int64)
    slots = np.concatenate([recs[..., 3:4], extra], axis=2)  # (P, N, slots)
    bits = bits.astype(np.int64)[:, None, None, None]
    return recs[None, ..., 1] + (bits > slots[None]).sum(axis=3)


def _plain_stages(cdf, radix, bits):
    """The plain version's decode: ``min(sum(u >= cdf), r - 1)``."""
    u = bits.astype(np.float64) * 2.0**-32
    c = (u[:, None, None, None] >= cdf[None]).sum(axis=3)
    return np.minimum(c, radix[None] - 1)


def _edge_cdfs():
    """(P=1, N, M=4) CDFs: 0 at the start, 1 reached early, exact multiples of
    2^-32 and their neighbours, a cumsum just above 1, NaN, +-inf, -0.0,
    unsorted rows."""
    ulp = 2.0**-32
    rows = [
        [0.0, 0.5, 1.0, 1.0],
        [0.0, 0.0, 0.0, 1.0],
        [ulp, 0.5 + ulp, 1.0, 1.0],
        [3 * ulp, 0.25 - ulp, 0.75, 1.0 + 2.0**-52],
        [0.25, np.nextafter(0.5, 1.0), np.nextafter(0.75, 0.0), 1.0],
        [0.3, np.nan, 0.9, 1.0],
        [np.nan, np.nan, np.nan, np.nan],
        [-np.inf, 0.5, np.inf, 1.0],
        [-0.0, 1.0 - ulp, 1.0 - 2 * ulp, 0.2],
        [1e-300, 2.0, -1.0, 0.6],
    ]
    return np.array(rows, dtype=np.float64)[None]


@pytest.mark.parametrize("radix_of", ["full", "mixed"])
def test_thresholds_decode_as_the_plain_version(radix_of):
    cdf = _edge_cdfs()
    n = cdf.shape[1]
    radix = np.full((1, n), 4) if radix_of == "full" else np.array([[1, 2, 3, 4, 2, 3, 4, 1, 4, 3]])
    recs, extra = K.mc_tables(torch.as_tensor(cdf), torch.as_tensor(radix, dtype=torch.int32),
                              torch.zeros((1, n), dtype=torch.int32), k1=0)
    assert recs.dtype == extra.dtype == torch.int32 and extra.shape == (1, n, 2)
    # every threshold, one below and one above it, the ends, random bits
    keys = np.ceil(np.nan_to_num(cdf, nan=2.0, posinf=2.0, neginf=-1.0) * 2.0**32).ravel()
    keys = keys[(keys >= 0) & (keys < 2.0**32)].astype(np.int64)
    edges = np.concatenate([keys - 1, keys, keys + 1, [0, 1, 2**31, 2**32 - 2, 2**32 - 1]])
    edges = edges[(edges >= 0) & (edges < 2**32)]
    bits = np.concatenate([edges, np.random.default_rng(0).integers(0, 2**32, 20_000)])
    np.testing.assert_array_equal(_kernel_stages(recs, extra, bits),
                                  _plain_stages(cdf, radix, bits))


def test_thresholds_of_generated_jobs_and_job_key():
    _, port_w = _workload(30, 3, seed=30)
    _, probs, num_stages = policies.padded_arrays(port_w)
    cdf = np.cumsum(probs, axis=1)
    gen = np.random.default_rng(4)
    orders = np.stack([gen.permutation(30) for _ in range(3)]).astype(np.int32)
    k0, k1 = rng.split_seed(SEED)
    recs, extra = K.mc_tables(torch.as_tensor(cdf[orders]),
                              torch.as_tensor(num_stages[orders].astype(np.int32)),
                              torch.as_tensor(orders), k1)
    np.testing.assert_array_equal(recs[..., 0].numpy().view(np.uint32),
                                  (orders.astype(np.uint64) + k1).astype(np.uint32))
    bits = np.random.default_rng(5).integers(0, 2**32, 5000)
    np.testing.assert_array_equal(_kernel_stages(recs, extra, bits),
                                  _plain_stages(cdf[orders], num_stages[orders], bits))


def test_mc_at_n1300_matches_reference():
    ref_w, port_w = _workload(1300, 2, seed=1300)
    orders = np.stack([policies.rank_order(port_w),
                       np.random.default_rng(7).permutation(1300)]).astype(np.int32)
    sizes, probs, num_stages = policies.padded_arrays(port_w)
    samples = (SEED, 2000)
    got = ops.sojourn_eval(sizes, probs, num_stages, orders, samples=samples, device="cpu")
    with jax.enable_x64(True):
        want = ref_ops.sojourn_eval(sizes, probs, num_stages, orders, samples=samples,
                                    impl="xla")
    for g, w in zip(got, want):
        assert _relerr(g, w) <= RTOL


def test_thresholds_decode_the_reference_stream():
    """The thresholds turn the stream's bits into the stop stages of the
    reference's own host replay (``u >= cdf`` on uniforms), at N = 6 over
    every stage count of M = 3."""
    from repro.kernels.sojourn_eval import rng as ref_rng

    _, port_w = _workload(6, 3, seed=11)
    _, probs, num_stages = policies.padded_arrays(port_w)
    n, samples = len(port_w), 3000
    k0, k1 = rng.split_seed(SEED)
    recs, extra = K.mc_tables(torch.as_tensor(np.cumsum(probs, axis=1)[None]),
                              torch.as_tensor(num_stages[None].astype(np.int32)),
                              torch.arange(n, dtype=torch.int32)[None], k1)
    x0 = np.repeat(np.arange(samples, dtype=np.uint32), n)
    x1 = np.tile(np.arange(n, dtype=np.uint32), samples)
    bits = rng.threefry2x32((k0, k1), x0, x1)[0].reshape(samples, n)
    got = np.stack([_kernel_stages(recs, extra, bits[:, j])[:, 0, j] for j in range(n)], axis=1)
    np.testing.assert_array_equal(got, ref_rng.host_outcomes(SEED, samples, probs, num_stages))


# ---------------------------------------------------------------------------
# the integer bound's count
# ---------------------------------------------------------------------------


def test_threefry_x_model_and_alu_count():
    mask = 0xFFFFFFFF
    counts = {"rot": 0, "xor": 0, "add": 0}

    def add(a, b):
        counts["add"] += 1
        return (a + b) & mask

    def block_x(k0, k1, x0, x1):
        """threefry2x32_x's schedule: x0 + k0 and x1 + k1 given; the last
        round's rotate and xor and the last x1 injection left out."""
        ks2 = k0 ^ k1 ^ 0x1BD11BDA
        a, b = (k1, ks2, k0, k1, ks2), (ks2 + 1, k0 + 2, k1 + 3, ks2 + 4)
        for g in range(5):
            for i, r in enumerate((13, 15, 26, 6) if g % 2 == 0 else (17, 29, 16, 24)):
                x0 = add(x0, x1)
                if g == 4 and i == 3:
                    break
                counts["rot"] += 1
                counts["xor"] += 1
                x1 = (((x1 << r) & mask) | (x1 >> (32 - r))) ^ x0
            x0 = add(x0, a[g])
            if g < 4:
                x1 = add(x1, b[g] & mask)
        return x0

    gen = np.random.default_rng(0)
    for _ in range(200):
        k0, k1 = (int(v) for v in gen.integers(0, 2**31, 2))
        s, j = (int(v) for v in gen.integers(0, 2**32, 2))
        want = rng.threefry2x32((k0, k1), np.array([s], np.uint32), np.array([j], np.uint32))[0]
        counts.update(rot=0, xor=0, add=0)
        assert block_x(k0, k1, (s + k0) & mask, (j + k1) & mask) == int(want[0])
    cs = _chip_smoke()
    assert counts["rot"] + counts["xor"] == cs.THREEFRY_ALU_OPS == 38
    assert sum(counts.values()) == cs.THREEFRY_OPS == 67
    assert cs.threefry_alu_ops(27, 1 << 23) == 38.0 * 27 * 2**23
