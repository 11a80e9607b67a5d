"""Port parity of the NumPy data layer: jobs, policies, theory, configs.

``repro_torch`` keeps its own copies of the JAX package's NumPy modules,
so the same ``np.random.Generator`` must give identical arrays, and a
workload carried across with ``from_reference`` must give identical
index tables.  Every comparison here is exact.  The ``REPRO_CACHE_DIR``
disk tier keeps the reference's file format, so each package reads the
other's entries.
"""

import dataclasses
import os

import numpy as np
import pytest

from repro.configs import paper_workloads as ref_cfg
from repro.core import jobs as ref_jobs
from repro.core import policies as ref_pol
from repro.core import theory as ref_theory
from repro_torch.configs import paper_workloads as port_cfg
from repro_torch.core import jobs as port_jobs
from repro_torch.core import policies as port_pol
from repro_torch.core import theory as port_theory

WORKLOAD_SETS = (1, 2, 3, 4, 5)


@pytest.mark.parametrize("num_stages", (1, 2, 4))
@pytest.mark.parametrize("workload_set", WORKLOAD_SETS)
def test_generate_workload_identical(workload_set, num_stages):
    ref = ref_jobs.generate_workload(np.random.default_rng(7), 9, num_stages, workload_set)
    port = port_jobs.generate_workload(np.random.default_rng(7), 9, num_stages, workload_set)
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(a.sizes, b.sizes)
        np.testing.assert_array_equal(a.probs, b.probs)
        assert (a.arrival, a.job_id, a.outcome_stage) == (b.arrival, b.job_id, b.outcome_stage)
    for x, y in zip(ref_jobs.pad_workload(ref), port_jobs.pad_workload(port)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("workload_set", WORKLOAD_SETS)
def test_policy_tables_identical(workload_set):
    ref = ref_jobs.generate_workload(np.random.default_rng(11), 8, 3, workload_set)
    port = port_jobs.from_reference(ref)
    for name in ("padded_arrays", "stage_durations", "rank_values", "erpt_values",
                 "sr_rank_values", "rank_order", "serpt_order"):
        a, b = getattr(ref_pol, name)(ref), getattr(port_pol, name)(port)
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y, err_msg=name)
    for policy in ("sr", "serpt", "rank", "fifo"):
        np.testing.assert_array_equal(
            ref_pol.index_table(ref, policy), port_pol.index_table(port, policy),
            err_msg=policy,
        )
    np.testing.assert_array_equal(
        ref_pol.random_order(ref, np.random.default_rng(3)),
        port_pol.random_order(port, np.random.default_rng(3)),
    )
    assert ref_pol.workload_key(ref) == port_pol.workload_key(port)


def test_from_reference_carries_every_field():
    ref = [
        ref_jobs.JobSpec(sizes=[1.0, 4.0], probs=[0.3, 0.7], arrival=2.5, job_id=7,
                         outcome_stage=1),
        ref_jobs.JobSpec(sizes=[2.0], probs=[1.0], arrival=0.0, job_id=3),
    ]
    port = port_jobs.from_reference(ref)
    assert all(type(j) is port_jobs.JobSpec for j in port)
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(a.sizes, b.sizes)
        np.testing.assert_array_equal(a.probs, b.probs)
        assert (a.arrival, a.job_id, a.outcome_stage) == (b.arrival, b.job_id, b.outcome_stage)
        assert (a.rank, a.erpt, a.num_stages) == (b.rank, b.erpt, b.num_stages)


def test_zero_survival_clamp_identical():
    # prefix mass rounding to 1 exercises the clamp in _conditional_arrays
    ref = [ref_jobs.JobSpec(sizes=[1.0, 2.0, 3.0], probs=[0.7, 0.3, 0.0]),
           ref_jobs.JobSpec(sizes=[0.5, 1.5], probs=[0.5, 0.5])]
    port = port_jobs.from_reference(ref)
    for policy in ("sr", "serpt", "rank"):
        np.testing.assert_array_equal(
            ref_pol.index_table(ref, policy), port_pol.index_table(port, policy)
        )


def test_theory_identical():
    ref = ref_jobs.generate_workload(np.random.default_rng(5), 6, 3, 2)
    port = port_jobs.from_reference(ref)
    p = np.array([0.2, 0.5, 0.9])
    np.testing.assert_array_equal(ref_theory.poisson_binomial(p), port_theory.poisson_binomial(p))
    assert ref_theory.beta_of(p) == port_theory.beta_of(p)
    for i, j in ((0, 1), (2, 5)):
        np.testing.assert_array_equal(ref_theory.q_ij(ref, i, j), port_theory.q_ij(port, i, j))
        assert ref_theory.alpha_ij(ref, i, j) == port_theory.alpha_ij(port, i, j)
        for d in (i, j):
            assert ref_theory.r_n(ref, i, j, d) == port_theory.r_n(port, i, j, d)


def test_paper_configs_identical():
    assert dataclasses.asdict(ref_cfg.NUMERICAL) == dataclasses.asdict(port_cfg.NUMERICAL)
    assert dataclasses.asdict(ref_cfg.TRACE) == dataclasses.asdict(port_cfg.TRACE)


@pytest.mark.parametrize("writer", ("ref", "port"))
def test_disk_cache_tier_shared_with_reference(writer, tmp_path, monkeypatch):
    """One package computes and stores the tables; the other, its memory
    cache cleared, loads the same bytes from disk as a disk hit."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    ref = ref_jobs.generate_workload(np.random.default_rng(61), 6, 3)
    port = port_jobs.from_reference(ref)
    mods = {"ref": (ref_pol, ref), "port": (port_pol, port)}
    (w_mod, w_jobs), (r_mod, r_jobs) = mods[writer], mods["port" if writer == "ref" else "ref"]
    for mod in (ref_pol, port_pol):
        mod.clear_workload_cache()
        mod.reset_cache_stats()
    stored = {p: w_mod.index_table(w_jobs, p) for p in ("sr", "serpt")}
    stored["padded"] = w_mod.padded_arrays(w_jobs)
    assert len(list(tmp_path.iterdir())) == 3
    for p in ("sr", "serpt"):
        loaded = r_mod.index_table(r_jobs, p)
        np.testing.assert_array_equal(loaded, stored[p])
        assert not loaded.flags.writeable
    for x, y in zip(r_mod.padded_arrays(r_jobs), stored["padded"]):
        np.testing.assert_array_equal(x, y)
    stats = r_mod.cache_stats()
    assert (stats["disk_hits"], stats["disk_misses"]) == (3, 0)


def test_disk_cache_eviction_and_cache_dir_as_reference(tmp_path, monkeypatch):
    """The size bound evicts the stalest entry, and ``ensure_cache_dir``
    resolves the directory exactly as the reference does."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    g = np.random.default_rng(62)
    w_a, w_b, w_c = (port_jobs.generate_workload(g, 5) for _ in range(3))
    port_pol.clear_workload_cache()
    port_pol.reset_cache_stats()
    port_pol.index_table(w_a, "sr")
    (file_a,) = tmp_path.iterdir()
    monkeypatch.setenv("REPRO_CACHE_DISK_BYTES", str(int(2.5 * file_a.stat().st_size)))
    port_pol.index_table(w_b, "sr")
    file_b = next(f for f in tmp_path.iterdir() if f != file_a)
    os.utime(file_a, (1_000, 1_000))
    os.utime(file_b, (500, 500))
    port_pol.index_table(w_c, "sr")
    names = {f.name for f in tmp_path.iterdir()}
    assert file_a.name in names and file_b.name not in names and len(names) == 2
    assert port_pol.cache_stats()["disk_evictions"] == 1

    monkeypatch.delenv("REPRO_CACHE_DIR")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert port_pol.default_cache_dir() == ref_pol.default_cache_dir()
    got = port_pol.ensure_cache_dir()
    assert got == str(tmp_path / "xdg" / "repro-workloads") and os.path.isdir(got)
    assert os.environ["REPRO_CACHE_DIR"] == got == ref_pol.ensure_cache_dir()
