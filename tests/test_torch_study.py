"""The port's study (``repro_torch.launch.study``) against ``benchmarks/run.py``.

The reference's harness is loaded by path with ``importlib`` and left as
it is.  Both sides are cut to a few trials the same way: ``_trials_for``
gives 2 or 3, ``NUMERICAL`` keeps N in {3, 4, 5}, workload sets {1, 4}
and stage counts {2, 3}, and ``TRACE`` keeps 300 jobs on 2 and 5
servers (``dataclasses.replace`` on each module's own config).  The
reference writes into ``tmp_path`` (its ``ART`` is patched), never into
the tracked ``artifacts/bench``.

The port runs with ``device="cpu"`` (the plain versions of the kernels);
the reference's evaluator needs the ``ref_x64`` fixture (ROADMAP fault
R1).  Sojourn values and competitive ratios must agree within 1e-9
relative, and trial counts and the host-side trace and fault tables
exactly; each saved JSON is ``{"rows": ..., "workload_cache": ...}``.
"""

import dataclasses
import importlib.util
import json
import pathlib

import pytest

from repro_torch.launch import study
from test_torch_evaluator import ref_x64  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-9


def _few_trials(n_jobs, full):
    return 3 if n_jobs <= 4 else 2


@pytest.fixture
def sides(monkeypatch, tmp_path):
    """(reference module, port output dir), both cut to size."""
    spec = importlib.util.spec_from_file_location("_ref_bench_run", ROOT / "benchmarks" / "run.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    monkeypatch.setattr(ref, "ART", str(tmp_path / "ref"))
    for mod in (ref, study):
        monkeypatch.setattr(mod, "_trials_for", _few_trials)
        monkeypatch.setattr(mod, "NUMERICAL", dataclasses.replace(
            mod.NUMERICAL, n_jobs_sweep=(3, 4, 5), workload_sets=(1, 4), stages_sweep=(2, 3)))
        monkeypatch.setattr(mod, "TRACE", dataclasses.replace(
            mod.TRACE, n_jobs_fast=300, server_counts=(2, 5)))
    return ref, str(tmp_path / "port")


def _close(got, want, key):
    """Within RTOL relative; a ``*_pct`` key is 100 (a / b - 1) of two such
    values, so its error is absolute: at most 2 RTOL (100 + |pct|)."""
    if isinstance(want, float):
        assert isinstance(got, float), key
        tol = 2 * RTOL * (100 + abs(want)) if key.endswith("_pct") else RTOL * abs(want)
        assert abs(got - want) <= tol, (key, got, want)
    else:
        assert got == want, key


def _assert_rows(got, want, exact=False):
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            if exact:
                assert g[key] == w[key], key
            else:
                _close(g[key], w[key], key)


def _saved(out, name, rows):
    doc = json.loads((pathlib.Path(out) / f"{name}.json").read_text())
    assert sorted(doc) == ["rows", "workload_cache"]
    assert {"hits", "misses", "hit_rate", "entries", "by_kind"} <= set(doc["workload_cache"])
    assert doc["rows"] == json.loads(json.dumps(rows))
    return doc["rows"]


def test_fig1(ref_x64, sides):
    ref, out = sides
    got = study.fig1_objective_gap(device="cpu", out=out)
    _assert_rows(got, ref.fig1_objective_gap())
    assert [r["n_jobs"] for r in got] == list(range(3, 11))
    _saved(out, "fig1", got)


def test_sojourn_and_competitive(ref_x64, sides):
    """The shared study, as ``--table all`` runs it, then both tables."""
    ref, out = sides
    shared = study._numerical_study(False, device="cpu")
    want = ref._numerical_study(False)
    assert sorted(shared) == sorted(want) == [(1, 3), (1, 4), (1, 5), (4, 3), (4, 4), (4, 5)]
    sojourn = study.table_sojourn(study=shared, out=out)
    _assert_rows(sojourn, ref.table_sojourn(study=want))
    assert [r["trials"] for r in sojourn] == [3, 3, 2] * 2
    competitive = study.table_competitive(study=shared, out=out)
    _assert_rows(competitive, ref.table_competitive(study=want))
    for r in sojourn:
        assert r["optimal"] <= min(r["rank"], r["serpt"], r["sr"], r["random"]) * (1 + RTOL)
    _saved(out, "table_sojourn", sojourn)
    _saved(out, "table_competitive", competitive)


def test_stages_through_the_cli(ref_x64, sides, capsys):
    ref, out = sides
    study.main(["--table", "stages", "--device", "cpu", "--out", out])
    assert "device: cpu" in capsys.readouterr().out
    got = json.loads((pathlib.Path(out) / "table_stages.json").read_text())["rows"]
    _assert_rows(got, json.loads(json.dumps(ref.table_stages())))
    assert [r["num_stages"] for r in got] == [2, 3]


def test_trace(sides):
    ref, out = sides
    got = study.table_trace(out=out)
    _assert_rows(got, ref.table_trace(), exact=True)
    assert [(r["dataset"], r["servers"]) for r in got] == [
        (d, w) for d in ("philly-synthetic", "synthetic-I", "synthetic-II") for w in (2, 5)]
    _saved(out, "table_trace", got)


def test_faults(sides):
    ref, out = sides
    got = study.table_faults(out=out)
    _assert_rows(got, ref.table_faults(), exact=True)
    assert [r["scenario"] for r in got] == ["clean", "faulty", "elastic"]
    assert got[1]["restarts"] > 0
    _saved(out, "table_faults", got)


def test_device_defaults_to_the_card(sides, monkeypatch):
    """Without ``--device`` the numerical tables ask for the CUDA card and
    raise when there is none; the host-side tables need no device."""
    _, out = sides
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        study.main(["--table", "fig1", "--out", out])
    with pytest.raises(RuntimeError, match="CUDA"):
        study.table_stages(out=out)
