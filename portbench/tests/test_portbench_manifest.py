"""BENCHMARK.json against the benchmark's contract, and every cell, config
and metric resolved by name, a throwaway cell added as files too."""

import json
import math
import re

import pytest
from portbench_testkit import BENCH, REPO, TINY, tiny_root

from portbench.harness import manifest, work

DOC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
}
CELLS = [w["name"] for w in DOC["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_document_keeps_to_the_contract():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 << 10
    assert DOC["paths"] == ["portbench"] and (REPO / "portbench").is_dir()
    assert DOC["command"][1] == "portbench/run.py" and len(DOC["command"]) <= 32
    assert all(_line(w) for w in DOC["command"])
    rs = DOC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    for section, (must, may) in KEYS.items():
        entries = DOC[section]
        assert entries and len({e["name"] for e in entries}) == len(entries)
        for e in entries:
            assert must <= set(e) <= must | may, e
            assert NAME.match(e["name"]), e["name"]
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert set(e2e) == {"groups_per_s", "group_p95_ms", "setup_s"}
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in DOC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DOC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= set(CELLS)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    used = {w["config"] for w in DOC["workloads"]}
    assert used == {c["name"] for c in DOC["configs"]}
    for c in DOC["configs"]:
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).is_file()
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    assert len({c["source"] for c in DOC["configs"]}) == len(DOC["configs"])
    for w in DOC["workloads"]:
        assert w["chips"] == 1 and _line(w["why"]) and NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in DOC["workloads"]}) == len(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_name(cell):
    c = manifest.load(REPO).cell(cell)
    assert c.chips == 1 and c.bench_dir == BENCH
    assert {m["name"] for m in c.end_to_end} == {"groups_per_s", "group_p95_ms", "setup_s"}
    assert c.per_layer
    for m in c.per_layer:
        assert callable(c.reader(m["name"]).read)
    assert set(c.traffic) == {"block", "max_groups_per_s", "compare_groups"}
    for n, wset, count in c.traffic["block"]:
        assert count >= 1 and str(wset) in c.config["workload_sets"]
        for kernel, n_evals in work.evaluations_by_kernel(c.config, n).items():
            m = int(c.config["num_stages"])
            probs = [[0.5] * m] * n
            k = c.config.get("mc_samples", m**n)
            w = c.count(kernel).work(probs, [m] * n, n_evals, k)
            assert w["flops"] > 0 and w["bytes"] > 0 and math.isfinite(w["stream"])


def test_a_throwaway_cell_added_as_files_resolves(tmp_path):
    bench = manifest.load(tiny_root(tmp_path))
    for name, (base, changes, block) in TINY.items():
        c = bench.cell(name)
        assert c.config["name"] == name and c.traffic["block"] == block
        assert all(c.config[k] == v for k, v in changes.items())
        assert {m["name"] for m in c.per_layer} == {m["name"] for m in DOC["per_layer"]}
        assert all(callable(c.reader(m["name"]).read) for m in c.per_layer)
    with pytest.raises(KeyError):
        bench.cell("no-such-cell")
