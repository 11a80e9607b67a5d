"""``BENCHMARK.json`` and the files it names, resolved by name.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel count is a file of its own under the benchmark's folder
(the first of ``paths``), found by its name:

* ``configs/<config>.json`` (the ``file`` of the configuration's entry);
* ``workloads/<traffic>.json``, the traffic mix a cell names;
* ``metrics/<metric>.py``, a reader with ``read(window) -> float | None``;
* ``counts/<kernel>.py``, a kernel's work with ``work(probs, num_stages,
  n_policies, count) -> dict``.

A later change adds a cell, a metric or a count by adding files and
entries; no file that is there needs an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

__all__ = ["Bench", "Cell", "load", "load_module"]


def load_module(path: Path, prefix: str):
    """The module of the file ``path``, loaded once under a name made of
    ``prefix`` and the file's stem (a name may hold dots and dashes)."""
    stem = "".join(c if c.isalnum() else "_" for c in path.stem)
    mod_name = f"portbench_{prefix}_{stem}"
    mod = sys.modules.get(mod_name)
    if mod is None or Path(mod.__file__).resolve() != path.resolve():
        if not path.is_file():
            raise FileNotFoundError(f"no file {path}")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[mod_name] = mod
    return mod


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple[dict, ...]
    per_layer: tuple[dict, ...]
    bench_dir: Path

    def reader(self, metric: str):
        return load_module(self.bench_dir / "metrics" / f"{metric}.py", "metric")

    def count(self, kernel: str):
        return load_module(self.bench_dir / "counts" / f"{kernel}.py", "count")


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


@dataclasses.dataclass(frozen=True)
class Bench:
    root: Path
    doc: dict

    @property
    def bench_dir(self) -> Path:
        return self.root / self.doc["paths"][0]

    def config(self, name: str) -> dict:
        for entry in self.doc["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> Cell:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                break
        else:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        traffic_path = self.bench_dir / "workloads" / f"{w['traffic']}.json"
        return Cell(
            name=name,
            chips=int(w["chips"]),
            config=self.config(w["config"]),
            traffic=json.loads(traffic_path.read_text()),
            end_to_end=tuple(m for m in self.doc["end_to_end"] if _applies(m, name)),
            per_layer=tuple(m for m in self.doc["per_layer"] if _applies(m, name)),
            bench_dir=self.bench_dir,
        )


def load(root: Path) -> Bench:
    """The benchmark of the checkout at ``root``."""
    root = Path(root)
    return Bench(root, json.loads((root / "BENCHMARK.json").read_text()))
