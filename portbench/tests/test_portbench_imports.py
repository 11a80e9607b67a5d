"""Nothing that portbench/run.py runs imports JAX or the JAX package, and
the plain reference and the work counts import nothing of the program: an
AST walk of every module they import, followed into the repo's files,
with top-level names compared whole."""

import ast
from pathlib import Path

import pytest
from portbench_testkit import BENCH, REPO

JAX = {"jax", "jaxlib", "flax", "repro"}
ROOTS = (REPO, REPO / "src")


def _module_file(name: str) -> Path | None:
    for root in ROOTS:
        base = root.joinpath(*name.split("."))
        for cand in (base.with_suffix(".py"), base / "__init__.py"):
            if cand.is_file():
                return cand
    return None


def _imports(path: Path) -> set[str]:
    """Dotted names that ``path`` imports (relative ones made absolute)."""
    tree = ast.parse(path.read_text(), str(path))
    src = REPO / "src"
    package = list(path.relative_to(src if src in path.parents else REPO).parent.parts)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package[:len(package) - node.level + 1]
                base = ".".join([*parts, *([base] if base else [])])
            out.add(base)
            out.update(f"{base}.{a.name}" for a in node.names)
    return out


def _walk(files) -> set[str]:
    """Top-level names of everything ``files`` import, transitively through
    the repo's own modules."""
    seen, names, todo = set(), set(), list(files)
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name in _imports(path):
            names.add(name.split(".")[0])
            found = _module_file(name)
            if found is not None:
                todo.append(found)
    return names


def _files(*dirs):
    return [p for d in dirs for p in sorted((BENCH / d).rglob("*.py"))]


def test_the_run_imports_no_jax():
    files = [BENCH / "run.py", BENCH / "control.py",
             *_files("harness", "metrics", "counts", "reference", "configs", "workloads")]
    names = _walk(files)
    assert "repro_torch" in names  # the walk follows into the program
    assert not names & JAX


@pytest.mark.parametrize("part", ["reference", "counts"])
def test_the_yardstick_imports_nothing_of_the_program(part):
    names = _walk(_files(part))
    assert "numpy" in names
    assert not names & (JAX | {"repro_torch"})
