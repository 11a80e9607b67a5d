"""The comparison that decides ``correct`` fails its control and the
faults a cell can have, and passes the program, on the CPU at a test size.

* The control: the plain reference computed in float32, the precision
  below the configuration's, put in the program's place: its readings, and
  a whole run with it planted in place of ``evaluate_many``.
* The faults, planted underneath the timed path of a whole run (the
  harness's look for a card skipped): an answer altered where a kernel's
  plain version produces it; half of the combinations or samples left out,
  the mean taken over the rest; a group answered with the previous group's
  results, the state left unchanged.  There is no exchange between chips:
  every cell takes one.
"""

import numpy as np
import pytest
import torch
from portbench_testkit import tiny_root

from portbench import control
from portbench.harness import manifest, session


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    import repro_torch.core.evaluator  # noqa: F401  (the program's import order)

    return manifest.load(tiny_root(tmp_path_factory.mktemp("root")))


@pytest.mark.parametrize("cell", ["tiny-exact", "tiny-mc", "tiny-study"])
def test_control_fails_the_limit_and_the_program_passes(bench, cell):
    c = bench.cell(cell)
    limit = c.config["limit"]["rel_gap"]
    for seed in (1, 2, 3):
        r = control.readings(c, seed, 1, True, torch.device("cpu"))
        assert max(r["program"].values()) <= limit / 1000
        assert max(r["control"].values()) > 3 * limit


def _altered(orig):
    def fn(*args, **kw):
        e_succ, e_all = orig(*args, **kw)
        return e_succ * (1 + 1e-6), e_all
    return fn


def _half_combinations(orig):
    def fn(probs, stage_durs, idx_tables, strides, radix, k_total, *rest):
        e_succ, e_all = orig(probs, stage_durs, idx_tables, strides, radix, k_total // 2, *rest)
        mass = probs[0, 0]  # job 0 is the leading digit: the first half has it stop first
        return e_succ / mass, e_all / mass
    return fn


def _half_samples(orig):
    def fn(cdf, stage_durs, idx_tables, radix, seed, n_samples, *rest):
        return orig(cdf, stage_durs, idx_tables, radix, seed, n_samples // 2, *rest)
    return fn


def _stale(orig):
    last = []

    def fn(*args, **kw):
        out = orig(*args, **kw)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return fn


FAULTS = {
    "answer altered": ("repro_torch.kernels.sojourn_eval.kernel", "sojourn_enum_torch",
                       _altered),
    "half the combinations": ("repro_torch.kernels.sojourn_eval.dynamic",
                              "dynamic_sojourn_enum_torch", _half_combinations),
    "half the samples": ("repro_torch.kernels.sojourn_eval.dynamic",
                         "dynamic_sojourn_mc_torch", _half_samples),
    "state unchanged": ("repro_torch.core.evaluator", "evaluate_many", _stale),
    "float32 control": ("repro_torch.core.evaluator", "evaluate_many", None),
}


@pytest.mark.parametrize("cell,fault", [
    ("tiny-exact", None), ("tiny-mc", None),
    ("tiny-exact", "answer altered"), ("tiny-exact", "half the combinations"),
    ("tiny-mc", "half the samples"), ("tiny-exact", "state unchanged"),
    ("tiny-study", None), ("tiny-study", "answer altered"), ("tiny-study", "state unchanged"),
    ("tiny-exact", "float32 control"), ("tiny-mc", "float32 control"),
    ("tiny-study", "float32 control"),
])
def test_a_run_is_correct_only_when_the_timed_path_is_sound(bench, monkeypatch, cell, fault):
    import importlib

    if fault is not None:
        module, name, plant = FAULTS[fault]
        mod = importlib.import_module(module)
        stand_in = (control.float32_evaluate_many(bench.cell(cell).config) if plant is None
                    else plant(getattr(mod, name)))
        monkeypatch.setattr(mod, name, stand_in)
    seconds = 0.05 if cell == "tiny-mc" else 0.3
    result = session.run(bench.cell(cell), 2**31 + 17, seconds, False, device="cpu")
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["correct"] is (fault is None), result["check"]
    assert set(result["metrics"]) == {"groups_per_s", "group_p95_ms", "setup_s"}
    assert all(np.isfinite(m["value"]) and m["value"] > 0 for m in result["metrics"].values())
    assert list(result)[-1] == "check"


def test_a_traced_run_reads_what_the_cpu_can_give(bench):
    result = session.run(bench.cell("tiny-exact"), 5, 0.2, True, device="cpu")
    assert result["correct"]
    assert set(result["metrics"]) == {"evaluator_self_ms"}  # no card: no device metric
