"""The plain reference against a hand enumeration at N = 3-4, its
Threefry copy bitwise against the program's plain stream, the generator
against the program's, and the reference against the program's plain
path at small sizes (a test may import the program; the reference may
not)."""

import itertools

import numpy as np
import pytest
import torch
from portbench_testkit import REPO  # noqa: F401  (puts the repo on the path)

from portbench.harness import traffic
from portbench.reference import evaluator as ref
from portbench.reference import threefry

POLICIES = ["rank", "random", "serpt", "sr"]


def _group(seed, n, m):
    rng = np.random.default_rng(seed)
    sizes, probs = traffic.draw_groups(rng, 1, n, m, "uniform", "uniform")
    return sizes[0], probs[0]


def _config(mode, **kw):
    return {"evaluation": mode, "policies": POLICIES, "max_exact_combos": 1 << 26,
            "mc_seed_bound": 1 << 62, **kw}


def _hand_mean(sizes, probs, stops, plan):
    """The mean completion time of one combination's successful jobs, by
    hand: a static order runs whole jobs; an index table serves, one stage
    at a time, the unfinished job of least index (ties to the lower job)."""
    n, m = sizes.shape
    done = {}
    if plan[0] == "order":
        clock = 0.0
        for j in plan[1]:
            clock += sizes[j, stops[j]]
            done[j] = clock
    else:
        idx, stage, clock = plan[1], [0] * n, 0.0
        dur = np.diff(sizes, axis=1, prepend=0.0)
        while len(done) < n:
            j = min((j for j in range(n) if j not in done), key=lambda j: (idx[j, stage[j]], j))
            clock += dur[j, stage[j]]
            if stage[j] == stops[j]:
                done[j] = clock
            stage[j] += 1
    won = [done[j] for j in range(n) if stops[j] == m - 1]
    return sum(won) / len(won) if won else 0.0


def _hand_plans(sizes, probs, rng):
    """Orders and tables worked out by hand from the paper's formulas."""
    n, m = sizes.shape
    rank = [sum(sizes[j] * probs[j]) / probs[j, -1] for j in range(n)]
    plans = {"rank": ("order", sorted(range(n), key=lambda j: (rank[j], j))),
             "random": ("order", list(rng.permutation(n)))}
    serpt, sr = np.empty((n, m)), np.empty((n, m))
    for j, s in itertools.product(range(n), range(m)):
        surv = 1.0 - sum(probs[j, :s])
        base = sizes[j, s - 1] if s else 0.0
        rem = [sizes[j, k] - base for k in range(s, m)]
        q = [probs[j, k] / surv for k in range(s, m)]
        serpt[j, s] = sum(r * p for r, p in zip(rem, q))
        sr[j, s] = min((sum(rem[i] * q[i] for i in range(k + 1))
                        + rem[k] * (1 - sum(q[:k + 1]))) / sum(q[:k + 1])
                       for k in range(len(rem)))
    plans.update(serpt=("index", serpt), sr=("index", sr))
    return plans


def _hand_exact(sizes, probs, plan):
    n, m = sizes.shape
    return sum(np.prod([probs[j, s] for j, s in enumerate(stops)])
               * _hand_mean(sizes, probs, stops, plan)
               for stops in itertools.product(range(m), repeat=n))


@pytest.mark.parametrize("n,m", [(3, 2), (4, 2), (3, 3)])
def test_exact_reference_matches_a_hand_enumeration(n, m):
    sizes, probs = _group(n * 10 + m, n, m)
    got = ref.evaluate(sizes, probs, _config("exact"), np.random.default_rng(7))
    plans = _hand_plans(sizes, probs, np.random.default_rng(7))
    for name, plan in plans.items():
        assert got[name] == pytest.approx(_hand_exact(sizes, probs, plan), rel=1e-12), name


@pytest.mark.parametrize("n,wset", [(3, 1), (4, 2), (4, 5)])
def test_optimal_is_the_least_of_every_order_by_hand(n, wset):
    from repro_torch.core.jobs import WORKLOAD_SETS

    rng = np.random.default_rng(n * 10 + wset)
    sizes, probs = traffic.draw_groups(rng, 1, n, 2, *WORKLOAD_SETS[wset])
    sizes, probs = sizes[0], probs[0]
    cfg = {**_config("exact"), "policies": ["optimal", "rank"]}
    got = ref.evaluate(sizes, probs, cfg, np.random.default_rng(1))
    want = min(_hand_exact(sizes, probs, ("order", order))
               for order in itertools.permutations(range(n)))
    assert got["optimal"] == pytest.approx(want, rel=1e-12)
    assert got["optimal"] <= got["rank"] * (1 + 1e-12)


def test_the_window_runs_through_the_block_in_shuffled_rounds():
    block = [[3, 1, 2], [8, 5, 1]]
    keys = traffic.sequence(np.random.default_rng(5), 7, block)
    assert len(keys) == 7
    for r in range(2):
        assert sorted(keys[3 * r:3 * r + 3]) == [(3, 1), (3, 1), (8, 5)]
    assert keys[6] in {(3, 1), (8, 5)}


def test_monte_carlo_reference_matches_a_hand_replay_of_the_stream():
    n, m, samples = 4, 3, 64
    sizes, probs = _group(5, n, m)
    got = ref.evaluate(sizes, probs, _config("monte_carlo", mc_samples=samples),
                       np.random.default_rng(9))
    rng = np.random.default_rng(9)
    seed = int(rng.integers(0, 1 << 62))
    plans = _hand_plans(sizes, probs, rng)
    key = threefry.split_seed(seed)
    cdf = np.cumsum(probs, axis=1)
    for name, plan in plans.items():
        total = 0.0
        for k in range(samples):
            bits, _ = threefry.threefry2x32(key, np.full(n, k, np.uint32),
                                            np.arange(n, dtype=np.uint32))
            u = bits.astype(np.float64) * 2.0**-32
            stops = [min(int((u[j] >= cdf[j]).sum()), m - 1) for j in range(n)]
            total += _hand_mean(sizes, probs, stops, plan)
        assert got[name] == pytest.approx(total / samples, rel=1e-12), name


def test_threefry_copy_is_bitwise_the_programs_stream():
    import repro_torch.core.evaluator  # noqa: F401  (the program's import order)
    from repro_torch.kernels.sojourn_eval import rng as prog

    gen = np.random.default_rng(3)
    for seed in (0, 1, (1 << 62) - 1, int(gen.integers(0, 1 << 62))):
        assert threefry.split_seed(seed) == prog.split_seed(seed)
        key = threefry.split_seed(seed)
        x0 = gen.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
        x1 = gen.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
        for a, b in zip(threefry.threefry2x32(key, x0, x1), prog.threefry2x32(key, x0, x1)):
            assert np.array_equal(a, b)
        t0, t1 = torch.as_tensor(x0.astype(np.int64)), torch.as_tensor(x1.astype(np.int64))
        for a, b in zip(threefry.threefry2x32_torch(key, t0, t1),
                        prog.threefry2x32_torch(key, t0, t1)):
            assert torch.equal(a, b)
        assert np.array_equal(threefry.threefry2x32(key, x0, x1)[0],
                              threefry.threefry2x32_torch(key, t0, t1)[0].numpy())


@pytest.mark.parametrize("m,wset", [(2, 1), (3, 1), (2, 2), (2, 5)])
def test_generator_draws_the_programs_groups(m, wset):
    from repro_torch.core.jobs import WORKLOAD_SETS, generate_workload

    sizes_kind, probs_kind = WORKLOAD_SETS[wset]
    sizes, probs = traffic.draw_groups(np.random.default_rng(11), 1, 9, m, sizes_kind,
                                       probs_kind)
    jobs = generate_workload(np.random.default_rng(11), 9, m, wset)
    assert np.array_equal(sizes[0], np.stack([j.sizes for j in jobs]))
    assert np.allclose(probs[0], np.stack([j.probs for j in jobs]), rtol=0, atol=1e-15)


@pytest.mark.parametrize("mode,n,samples,policies", [
    pytest.param("exact", 9, 0, POLICIES, id="exact-9-0"),
    pytest.param("monte_carlo", 27, 1024, POLICIES, id="monte_carlo-27-1024"),
    pytest.param("exact", 6, 0, ["optimal", "rank", "serpt", "sr", "random"],
                 id="study-exact-6-0")])
def test_reference_agrees_with_the_programs_plain_path(mode, n, samples, policies):
    from repro_torch.core.evaluator import evaluate_many
    from repro_torch.core.jobs import JobSpec

    sizes, probs = _group(n, n, 2)
    jobs = [JobSpec(sizes=sizes[i], probs=probs[i], job_id=i) for i in range(n)]
    kw = {"mc_samples": samples} if samples else {}
    got = evaluate_many(jobs, tuple(policies), np.random.default_rng(4), device="cpu", **kw)
    want = ref.evaluate(sizes, probs, {**_config(mode, mc_samples=samples),
                                       "policies": policies}, np.random.default_rng(4))
    for name in policies:
        assert got[name] == pytest.approx(want[name], rel=1e-12), name
