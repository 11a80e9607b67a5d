"""The frozen work counts and peaks equal chip_smoke.py's at the cells'
shapes (a test may import chip_smoke; the harness may not)."""

import numpy as np
import pytest
import torch
from portbench_testkit import BENCH, REPO

from portbench.harness import manifest, peaks

SHAPES = [("m2-exact-n26", 26, 1 << 26, False), ("m2-mc-n80", 80, 1 << 23, True)]


@pytest.fixture(scope="module")
def smoke():
    import repro_torch.core.evaluator  # noqa: F401  (the program's import order)
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("cell,n,count,mc", SHAPES)
def test_counts_equal_chip_smokes(smoke, cell, n, count, mc):
    from repro_torch.core import policies
    from repro_torch.core.jobs import generate_workload

    c = manifest.load(REPO).cell(cell)
    assert c.traffic["block"] == [[n, 1, 1]]
    assert count == (c.config["mc_samples"] if mc else 2**n)
    jobs = generate_workload(np.random.default_rng(n), n)
    _, probs, num_stages = policies.padded_arrays(jobs)
    cpu = torch.device("cpu")
    samples = (12345, count) if mc else None
    static = c.count("sojourn_mc" if mc else "sojourn_enum").work(probs, num_stages, 1, count)
    order = policies.rank_order(jobs)[None]
    assert static["flops"] == pytest.approx(smoke.static_flops(jobs, order, count, mc),
                                            rel=1e-12)
    assert static["bytes"] == smoke.tensor_bytes(smoke.static_args(jobs, order, cpu,
                                                                   samples)) + 16
    dyn = c.count("dynamic_sojourn_mc" if mc else "dynamic_sojourn_enum").work(
        probs, num_stages, 1, count)
    assert dyn["flops"] == pytest.approx(smoke.dynamic_flops(jobs, 1, count, mc), rel=1e-12)
    table = [policies.index_table(jobs, "sr")]
    assert dyn["bytes"] == smoke.tensor_bytes(smoke.dynamic_args(jobs, table, cpu,
                                                                 samples)) + 16
    stream = smoke.threefry_alu_ops(n, count) if mc else 0.0
    assert static["stream"] == dyn["stream"] == stream


def test_peaks_equal_chip_smokes(smoke):
    assert peaks.FP64_FLOPS == smoke.FP64_FLOPS
    assert peaks.HBM_BYTES_PER_S == smoke.HBM_BYTES_PER_S
    assert (peaks.ALU_LANES_PER_SM, peaks.SM_COUNT) == (smoke.ALU_LANES_PER_SM, smoke.SM_COUNT)
    p = peaks.Peaks(peaks.FP64_FLOPS, peaks.HBM_BYTES_PER_S, 64 * 132 * 1.98e9, 1980.0, 700.0)
    smoke._CLOCK[:] = [1.98e9]
    terms = smoke.bound_terms(3.4e9, 1 << 20, 16, alu_ops=2.5e10)
    assert p.least_seconds(3.4e9, (1 << 20) + 16, 2.5e10) * 1e3 == pytest.approx(
        max(terms.values()), rel=1e-12)


@pytest.mark.parametrize("n", [3, 8])
def test_optimal_counts_every_order_as_chip_smoke_does(smoke, n):
    import itertools

    from repro_torch.core import policies
    from repro_torch.core.jobs import generate_workload

    c = manifest.load(REPO).cell("m2-study-n3-8")
    assert [n, 1, 1] in c.traffic["block"]
    jobs = generate_workload(np.random.default_rng(n), n)
    _, probs, num_stages = policies.padded_arrays(jobs)
    orders = np.array(list(itertools.permutations(range(n))), dtype=np.int32)
    w = c.count("sojourn_enum").work(probs, num_stages, len(orders), 2**n)
    assert w["flops"] == pytest.approx(smoke.static_flops(jobs, orders, 2**n, False), rel=1e-12)
    assert w["bytes"] == len(orders) * (
        smoke.tensor_bytes(smoke.static_args(jobs, orders[:1], torch.device("cpu"))) + 16)


@pytest.mark.parametrize("cell,n,kernels", [
    pytest.param("m2-exact-n26", 26, {"sojourn_enum": 2, "dynamic_sojourn_enum": 2},
                 id="m2-exact-n26-kernels0"),
    pytest.param("m2-mc-n80", 80, {"sojourn_mc": 2, "dynamic_sojourn_mc": 2},
                 id="m2-mc-n80-kernels1"),
    pytest.param("m2-study-n3-8", 8, {"sojourn_enum": 2 + 40320, "dynamic_sojourn_enum": 2},
                 id="m2-study-n3-8-kernels2"),
])
def test_each_policy_is_counted_by_its_kernel(cell, n, kernels):
    from portbench.harness.work import evaluations_by_kernel

    config = manifest.load(REPO).cell(cell).config
    assert evaluations_by_kernel(config, n) == kernels
    assert all((BENCH / "counts" / f"{k}.py").is_file() for k in kernels)
