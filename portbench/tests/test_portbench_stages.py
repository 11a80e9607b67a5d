"""Four-stage jobs (``m4-exact-n13``, configuration ``paper-set1-m4``): the
plain reference against a hand enumeration and the program's plain path at
M = 4, the generator against the program's, the exact cap met at equality
by 13 four-stage jobs, the frozen counts against brute-force tallies of a
radix-4 walk, and the readers of the two counters of the stage count's
regime (a test may import the program; the reference may not)."""

import itertools

import numpy as np
import pytest
from portbench_testkit import REPO
from test_portbench_counts import \
    test_each_policy_is_counted_by_its_kernel as _counted_by_its_kernel
from test_portbench_reference import \
    test_exact_reference_matches_a_hand_enumeration as _hand_enumeration
from test_portbench_reference import \
    test_generator_draws_the_programs_groups as _generator

from portbench.harness import manifest, peaks, session, traffic, work
from portbench.harness.session import Window
from portbench.harness.trace import Trace
from portbench.reference import evaluator as ref

CELL = "m4-exact-n13"
POLICIES = ["rank", "random", "serpt", "sr"]


def _group(seed, n, m):
    rng = np.random.default_rng(seed)
    sizes, probs = traffic.draw_groups(rng, 1, n, m, "uniform", "uniform")
    return sizes[0], probs[0]


def _jobs(sizes, probs):
    from repro_torch.core.jobs import JobSpec

    return [JobSpec(sizes=sizes[i], probs=probs[i], job_id=i) for i in range(len(sizes))]


def _cell():
    return manifest.load(REPO).cell(CELL)


@pytest.mark.parametrize("n,m", [(3, 4)])
def test_exact_reference_matches_a_hand_enumeration_at_four_stages(n, m):
    _hand_enumeration(n, m)


@pytest.mark.parametrize("m,wset", [(4, 1)])
def test_generator_draws_the_programs_four_stage_groups(m, wset):
    _generator(m, wset)


@pytest.mark.parametrize("mode,n,samples", [
    pytest.param("exact", 7, 0, id="exact-7-0"),
    pytest.param("monte_carlo", 20, 1024, id="monte_carlo-20-1024")])
def test_reference_agrees_with_the_programs_plain_path_at_four_stages(mode, n, samples):
    from repro_torch.core.evaluator import evaluate_many

    sizes, probs = _group(n, n, 4)
    jobs = _jobs(sizes, probs)
    kw = {"mc_samples": samples} if samples else {}
    got = evaluate_many(jobs, tuple(POLICIES), np.random.default_rng(4), device="cpu", **kw)
    cfg = {"evaluation": mode, "policies": POLICIES, "max_exact_combos": 1 << 26,
           "mc_seed_bound": 1 << 62, "mc_samples": samples}
    want = ref.evaluate(sizes, probs, cfg, np.random.default_rng(4))
    for name in POLICIES:
        assert got[name] == pytest.approx(want[name], rel=1e-12), name


def test_thirteen_four_stage_jobs_are_exact_at_the_cap():
    """4^13 equals the cap: the harness, the reference and the program all
    take it as exact, and one job more as past it.  Nothing is evaluated:
    the reference is stopped by a policy it does not have, which it looks
    up only once its cap is passed."""
    from repro_torch.core import evaluator as ev

    cell = _cell()
    cfg = cell.config
    assert cfg["num_stages"] == 4 and cell.traffic["block"] == [[13, 1, 1]]
    assert 4**13 == int(cfg["max_exact_combos"]) == ev.MAX_EXACT_COMBOS
    at, past = _group(13, 13, 4), _group(14, 14, 4)
    session._check_regime(cell, [at])
    with pytest.raises(ValueError, match="is not evaluated by exact"):
        session._check_regime(cell, [past])
    no_policy = {**cfg, "policies": ["no-such-policy"]}
    with pytest.raises(ValueError, match="no reference policy"):
        ref.evaluate(*at, no_policy, np.random.default_rng(0))
    with pytest.raises(ValueError, match="exceed max_exact_combos"):
        ref.evaluate(*past, no_policy, np.random.default_rng(0))
    at_jobs, past_jobs = _jobs(*at), _jobs(*past)
    assert ev.exact_combination_count(at_jobs) == 4**13
    ev._check_exact(at_jobs)
    assert ev.exact_combination_count(past_jobs) == 4**14
    with pytest.raises(ValueError, match="exceed MAX_EXACT_COMBOS"):
        ev._check_exact(past_jobs)


def test_static_count_is_a_radix_4_walks_tally():
    """``sojourn_enum``'s count at N = 4, M = 4: the walk serves every
    position whose prefix changed since the last combination (three
    operations a position, one more where it is a success), then the
    six-operation tail a combination."""
    n, m = 4, 4
    serves = successes = 0
    last = None
    for stops in itertools.product(range(m), repeat=n):  # service order, position 0 first
        first = 0 if last is None else next(q for q in range(n) if stops[q] != last[q])
        serves += n - first
        successes += sum(stops[q] == m - 1 for q in range(first, n))
        last = stops
    assert serves == sum(m ** (q + 1) for q in range(n))
    probs = np.full((n, m), 1.0 / m)
    w = _cell().count("sojourn_enum").work(probs, [m] * n, 1, m**n)
    assert w["flops"] == 3 * serves + successes + 6 * m**n
    assert w["bytes"] == 2 * n * m * 8 + 2 * n * 4 + 2 * 8 and w["stream"] == 0.0


def test_dynamic_count_is_a_hand_lockstep_tally():
    """``dynamic_sojourn_enum``'s count at N = 4, M = 4: over all 256
    combinations a hand simulation of SR on one server adds the clock once
    a seat and a success once a successful job, besides each combination's
    N weight products, N completion adds and six-operation tail."""
    n, m = 4, 4
    sizes, probs = _group(44, n, m)
    idx = ref.load_policy("sr").plan(sizes, probs, np.random.default_rng(0))
    seats = succ_adds = 0
    for stops in itertools.product(range(m), repeat=n):
        stage, done = [0] * n, set()
        while len(done) < n:
            j = min((j for j in range(n) if j not in done), key=lambda j: (idx[j, stage[j]], j))
            seats += 1
            if stage[j] == stops[j]:
                done.add(j)
                succ_adds += stops[j] == m - 1
            stage[j] += 1
    w = _cell().count("dynamic_sojourn_enum").work(probs, [m] * n, 1, m**n)
    assert w["flops"] == m**n * (2 * n + 6) + seats + succ_adds
    assert w["bytes"] == 3 * n * m * 8 + 2 * n * 4 + 2 * 8 and w["stream"] == 0.0


@pytest.mark.parametrize("cell,n,m,static_ms,dynamic_ms", [
    pytest.param(CELL, 13, 4, 0.0204, 0.134, id="m4-exact-n13"),
    pytest.param("m2-exact-n26", 26, 2, 0.0257, 0.217, id="m2-exact-n26")])
def test_group_work_gives_each_launchs_bound(cell, n, m, static_ms, dynamic_ms):
    c = manifest.load(REPO).cell(cell)
    _, probs = _group(n, n, m)
    w = work.group_work(c, probs)
    assert set(w) == {"sojourn_enum", "dynamic_sojourn_enum"}
    p = peaks.Peaks(peaks.FP64_FLOPS, peaks.HBM_BYTES_PER_S, 1.0, 1980.0, 700.0)
    for kernel, want in (("sojourn_enum", static_ms), ("dynamic_sojourn_enum", dynamic_ms)):
        k = w[kernel]  # two launches a group: RANK and RANDOM, SERPT and SR
        least = p.least_seconds(k["flops"] / 2, k["bytes"] / 2, k["stream"] / 2)
        assert least * 1e3 == pytest.approx(want, rel=5e-3), kernel


@pytest.mark.parametrize("cell,n,kernels", [
    pytest.param(CELL, 13, {"sojourn_enum": 2, "dynamic_sojourn_enum": 2},
                 id="m4-exact-n13-kernels3")])
def test_each_policy_is_counted_by_its_kernel_at_four_stages(cell, n, kernels):
    _counted_by_its_kernel(cell, n, kernels)


# ---------------------------------------------------------------------------
# The readers of the stage count's regime
# ---------------------------------------------------------------------------

N_GROUPS = 4
LAUNCHES = {"sojourn_enum": 8, "sojourn_mc": 0, "sojourn_outcomes": 0,
            "dynamic_sojourn_enum": 6, "dynamic_sojourn_mc": 2}
READERS = {"enum_suffix_len": ("prof.ops.enum_suffix", 40, 40 / 8),
           "dynamic_entries_per_launch": ("prof.ops.dynamic_entries", 416, 416 / 8)}


@pytest.fixture
def registry(monkeypatch):
    from repro_torch.obs import metrics

    reg = metrics.MetricsRegistry()
    monkeypatch.setattr(metrics, "_DEFAULT", reg)
    reg.histogram("prof.sojourn_eval.static.enum.cuda.seconds").observe(0.5)
    return reg


def _window() -> Window:
    return Window(N_GROUPS, np.full(N_GROUPS, 1.0), 5.0,
                  {"prof.sojourn_eval.static.enum.cuda.seconds": 0.5}, dict(LAUNCHES),
                  Trace([], [], 0.0, []), None, [])


@pytest.mark.parametrize("metric", sorted(READERS))
def test_the_regime_readers_give_their_ratio_or_nothing(registry, metric):
    counter, total, want = READERS[metric]
    reader = _cell().reader(metric)
    assert reader.read(_window()) is None  # a program that counts no such name
    registry.counter(counter).inc(total)
    assert reader.read(_window()) == pytest.approx(want, rel=1e-12)
    no_launch = _window()
    no_launch.launches = {}
    assert reader.read(no_launch) is None
