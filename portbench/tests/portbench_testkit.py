"""Helpers of the benchmark's CPU tests: a throwaway checkout root holding
the benchmark's files plus two tiny cells that the plain versions of the
program run in well under a second a group."""

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "portbench"
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: The tiny cells: exact at N = 8 (K = 256), Monte Carlo at N = 27 (past
#: 2^26 combinations) with 1024 samples a group, and the study's five
#: policies on a block of its sets at N = 3-5.
TINY = {
    "tiny-exact": ("paper-m2-exact", {}, [[8, 1, 1]]),
    "tiny-mc": ("paper-m2-mc", {"mc_samples": 1024}, [[27, 1, 1]]),
    "tiny-study": ("paper-study-m2", {}, [[3, 1, 1], [4, 2, 1], [4, 3, 1], [5, 4, 1],
                                          [5, 5, 1]]),
}


def tiny_root(tmp: Path) -> Path:
    """A checkout root under ``tmp`` with BENCHMARK.json, the benchmark's
    data files and the cells of :data:`TINY`."""
    root = Path(tmp)
    for sub in ("configs", "workloads", "metrics", "counts"):
        shutil.copytree(BENCH / sub, root / "portbench" / sub)
    doc = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, (base, changes, block) in TINY.items():
        cfg = json.loads((BENCH / "configs" / f"{base}.json").read_text())
        cfg.update(name=name, **changes)
        (root / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        traffic = {"block": block, "max_groups_per_s": 400, "compare_groups": 2}
        (root / "portbench" / "workloads" / f"{name}.json").write_text(json.dumps(traffic))
        doc["configs"].append({"name": name, "source": "a test", "file":
                               f"portbench/configs/{name}.json", "reduced": sorted(changes),
                               "why": "a test"})
        doc["workloads"].append({"name": name, "config": name, "traffic": name, "chips": 1,
                                 "why": "a test"})
        for m in doc["per_layer"]:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root
