"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU fallback.

* Importing ``repro_torch`` and its entry points in a fresh interpreter
  leaves ``jax`` and every ``repro.*`` module out of ``sys.modules``.
* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  them (an AST scan of every import statement).
* ``chip_smoke.py`` exits non-zero and prints no result without CUDA,
  in the repository and alone in an empty directory.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a machine that has one
    env.update(extra)
    return env


def test_import_leaves_out_jax_and_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.core.evaluator\n"
        "import repro_torch.quickstart, repro_torch.core.theory\n"
        "import repro_torch.configs.paper_workloads, repro_torch.kernels.sojourn_eval\n"
        "import repro_torch.kernels._build, repro_torch.kernels.flash_attention\n"
        "import repro_torch.launch.serve, repro_torch.models.transformer\n"
        "import repro_torch.kernels.ssd_scan, repro_torch.kernels.moe_gemm\n"
        "import repro_torch.models.ssm, repro_torch.models.moe\n"
        "import repro_torch.core.des, repro_torch.core.simulator, repro_torch.core.trace\n"
        "import repro_torch.cluster, repro_torch.cluster.faults, repro_torch.cluster.manager\n"
        "import repro_torch.obs.recorder, repro_torch.obs.report, repro_torch.launch.study\n"
        "import repro_torch.models.frontends, repro_torch.examples\n"
        "import repro_torch.examples.train_early_termination\n"
        "import repro_torch.examples.cluster_schedule\n"
        "import repro_torch.parallel.sharding, repro_torch.launch.mesh\n"
        "import repro_torch.launch.roofline, repro_torch.launch.dryrun\n"
        "import repro_torch.optim.compress, repro_torch.configs.shapes\n"
        "import repro_torch.launch.train, repro_torch.launch.serve\n"
        "from repro_torch.configs import registry\n"
        "[registry.get_config(a) for a in registry.ARCHS]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_training_modules_leave_out_jax_and_repro():
    """The training path (optimizer, data, checkpoints, trainer) imports
    neither JAX nor the reference, and its CLI runs on the CPU without
    them."""
    code = (
        "import sys\n"
        "import repro_torch.launch.train, repro_torch.optim, repro_torch.data.pipeline\n"
        "import repro_torch.ckpt, repro_torch.optim.schedule\n"
        "repro_torch.launch.train.main(['--smoke', '--device', 'cpu', '--steps', '1',\n"
        "                               '--batch', '2', '--seq', '16'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", PORT_SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


@pytest.mark.parametrize("alone", (False, True), ids=("in_repo", "alone"))
def test_chip_smoke_fails_without_cuda(tmp_path, alone):
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = _env()
    if alone:
        env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, str(script)], env=env, capture_output=True,
                          text=True, timeout=120, cwd=cwd)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert '"kernels"' not in proc.stdout
