"""Checkpoints of a meshed run (ROADMAP fault P7), against the JAX
package's checkpoint format and its single-device trainer.

Eight gloo ranks (one spawn: a script under ``tmp_path``, its ranks
joined through a ``file://`` store there, never a TCP port; the whole
spawn under a 300 s limit) run Qwen3-1.7B SMOKE in float32 on a 4 x 2
("data", "model") mesh:

* a meshed ``Trainer`` saves after 2 steps; a fresh meshed ``Trainer``
  restores that file and runs 2 more; an unbroken 4-step run gives the
  same 4 losses, bitwise;
* the file restores onto the 4 x 2 mesh and onto a 2 x 4 mesh, every
  leaf placed as a fresh init places it, each rank holding only its
  shard, and every leaf's ``full_tensor()`` bitwise equal to the array in
  the ``.npz``;
* a checkpoint that the reference's single-device ``Trainer`` wrote
  restores onto the 4 x 2 mesh, bitwise.

In the test process the meshed run's file restores onto one device
bitwise, the reference's ``CheckpointManager.restore`` reads it bitwise,
and it holds what an unmeshed save of the same values holds (manifest
and arrays).  Last, ``python -m repro_torch.launch.train --mesh 1x1
--ckpt-dir D``, run twice, resumes at step 2 the second time.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as RefCheckpointManager
from repro.ckpt.checkpoint import _flatten_with_names
from repro.configs import registry as ref_registry
from repro.data import pipeline as ref_pipeline
from repro.launch import train as ref_train
from repro_torch.ckpt.checkpoint import CheckpointManager, _named_leaves
from repro_torch.configs import registry
from repro_torch.launch import train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-1.7b"
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
B, S = 8, 16
MESHES = ("4x2", "2x4")
#: The step at which the meshed run saves, and the steps of the unbroken run.
SAVED, STEPS = 2, 4

RANKS = textwrap.dedent('''
    import logging, pickle, sys
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def compare(tree, want, target):
        """(names of leaves that differ from the file or are misplaced,
        whether every rank holds only its shards)."""
        from repro_torch.ckpt.checkpoint import _named_leaves

        bad, shards_only = [], True
        targets = dict(_named_leaves(target))
        for name, leaf in _named_leaves(tree):
            if not isinstance(leaf, torch.Tensor):
                bad += [] if leaf == int(want[name]) else [name]
                continue
            local = leaf.to_local()
            shards_only &= local.untyped_storage().nbytes() == local.nbytes
            placed = (leaf.device_mesh == targets[name].device_mesh
                      and leaf.placements == targets[name].placements)
            got = leaf.full_tensor().numpy()
            if not placed or got.dtype != want[name].dtype or not np.array_equal(got, want[name]):
                bad.append(name)
        return bad, shards_only


    def run(rank, world, store, tmp):
        torch.set_num_threads(1)
        logging.disable(logging.WARNING)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=240))
        from repro_torch.ckpt.checkpoint import CheckpointManager
        from repro_torch.configs.registry import get_smoke
        from repro_torch.data.pipeline import DataConfig, SyntheticLM
        from repro_torch.launch import train
        from repro_torch.launch.mesh import make_host_mesh

        cfg = get_smoke(%(ARCH)r, param_dtype="float32", compute_dtype="float32")
        meshes = {"4x2": make_host_mesh(4, 2, device_type="cpu"),
                  "2x4": make_host_mesh(2, 4, device_type="cpu")}

        def plan(mesh):
            return train.default_plan(cfg, meshes[mesh], warmup_steps=1, total_steps=%(STEPS)d)

        def trainer(ckpt_dir=None):
            data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=%(S)d,
                                          global_batch=%(B)d))
            return train.Trainer(plan("4x2"), data, ckpt_dir and CheckpointManager(ckpt_dir))

        run_dir = f"{tmp}/meshed"
        _, _, first = trainer(run_dir).run(%(SAVED)d, log_every=0)
        _, _, resumed = trainer(run_dir).run(%(STEPS)d - %(SAVED)d, log_every=0)
        _, _, straight = trainer().run(%(STEPS)d, log_every=0)
        out = {"losses": {"first": first, "resumed": resumed, "straight": straight},
               "restored": {}}
        for src, step, onto in (("meshed", %(SAVED)d, ("4x2", "2x4")), ("reference", 1, ("4x2",))):
            with np.load(f"{tmp}/{src}/step_{step}.npz") as f:
                want = {k: f[k] for k in f.files}
            for mesh in onto:
                params, state = train._abstract_state(plan(mesh))
                target = {"params": params, "opt": state}
                tree = CheckpointManager(f"{tmp}/{src}").restore(step, target, device="cpu")
                out["restored"][f"{src} onto {mesh}"] = compare(tree, want, target)
        if rank == 0:
            with open(f"{tmp}/out.pkl", "wb") as f:
                pickle.dump(out, f)
        dist.destroy_process_group()


    if __name__ == "__main__":
        store, tmp = sys.argv[1:]
        mp.spawn(run, args=(8, store, tmp), nprocs=8)
''') % {"ARCH": ARCH, "B": B, "S": S, "SAVED": SAVED, "STEPS": STEPS}


def _ref_plan():
    return ref_train.default_plan(ref_registry.get_smoke(ARCH, **F32), warmup_steps=1,
                                  total_steps=STEPS)


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    """The ranks' results and the directory of their checkpoints; the
    reference's single-device trainer writes its file (step 1) first."""
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    cfg = ref_registry.get_smoke(ARCH, **F32)
    data = ref_pipeline.SyntheticLM(ref_pipeline.DataConfig(vocab_size=cfg.vocab_size,
                                                            seq_len=S, global_batch=B))
    ref_train.Trainer(_ref_plan(), data, RefCheckpointManager(str(tmp / "reference"))).run(
        1, log_every=0)
    (tmp / "ranks.py").write_text(RANKS)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, str(tmp / "ranks.py"), str(tmp / "store"),
                             str(tmp)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=tmp)
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-4000:] + err[-8000:]
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f), tmp


def _saved(tmp) -> dict:
    with np.load(tmp / "meshed" / f"step_{SAVED}.npz") as f:
        return {k: f[k] for k in f.files}


def test_resumed_meshed_run_equals_an_unbroken_run(meshed):
    losses = meshed[0]["losses"]
    assert len(losses["straight"]) == STEPS and np.all(np.isfinite(losses["straight"]))
    assert losses["first"] + losses["resumed"] == losses["straight"]


@pytest.mark.parametrize("src", [f"meshed onto {m}" for m in MESHES] + ["reference onto 4x2"])
def test_checkpoint_restores_onto_the_mesh_bitwise(meshed, src):
    """Every leaf placed as a fresh init on that mesh places it, each rank
    holding only its shards, and gathered equal to the file's array."""
    bad, shards_only = meshed[0]["restored"][src]
    assert bad == []
    assert shards_only


def test_meshed_checkpoint_restores_onto_one_device_bitwise(meshed):
    tmp = meshed[1]
    want = _saved(tmp)
    plan = train.default_plan(registry.get_smoke(ARCH, **F32), device="cpu")
    params, state = train._abstract_state(plan)
    tree = CheckpointManager(str(tmp / "meshed")).restore(SAVED, {"params": params, "opt": state},
                                                          device="cpu")
    assert tree["opt"].step == SAVED
    named = _named_leaves(tree)
    assert sorted(name for name, _ in named) == sorted(want)
    for name, leaf in named:
        if isinstance(leaf, torch.Tensor):
            assert leaf.device.type == "cpu", name
            np.testing.assert_array_equal(leaf.numpy(), want[name], err_msg=name)


def test_reference_restores_the_meshed_checkpoint_bitwise(meshed):
    tmp = meshed[1]
    want = _saved(tmp)
    plan = _ref_plan()
    abstract = jax.eval_shape(lambda k: ref_train.make_init(plan)(k), jax.random.PRNGKey(0))
    tree = RefCheckpointManager(str(tmp / "meshed")).restore(
        SAVED, {"params": abstract[0], "opt": abstract[1]})
    named = _flatten_with_names(tree)
    assert sorted(name for name, _ in named) == sorted(want)
    for name, leaf in named:
        np.testing.assert_array_equal(np.asarray(leaf), want[name], err_msg=name)


def test_meshed_checkpoint_is_the_file_of_an_unmeshed_save(meshed, tmp_path):
    """An unmeshed save of the same values writes the same manifest and
    the same arrays (the zip container's timestamps aside)."""
    tmp = meshed[1]
    plan = train.default_plan(registry.get_smoke(ARCH, **F32), device="cpu")
    params, state = train._abstract_state(plan)
    tree = CheckpointManager(str(tmp / "meshed")).restore(SAVED, {"params": params, "opt": state},
                                                          device="cpu")
    CheckpointManager(str(tmp_path)).save(SAVED, tree, blocking=True)
    manifests = [json.loads((d / f"step_{SAVED}.json").read_text()) for d in (tmp / "meshed",
                                                                              tmp_path)]
    assert manifests[0] == manifests[1]
    want = _saved(tmp)
    with np.load(tmp_path / f"step_{SAVED}.npz") as got:
        assert sorted(got.files) == sorted(want)
        for name in got.files:
            assert got[name].dtype == want[name].dtype, name
            assert got[name].tobytes() == want[name].tobytes(), name


def test_cli_meshed_run_resumes_from_its_checkpoint(tmp_path):
    """``launch.train --mesh 1x1 --ckpt-dir D`` twice: the second run
    restores step 2 and saves step 4."""
    ckpt = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--smoke", "--device", "cpu",
           "--mesh", "1x1", "--ckpt-dir", str(ckpt), "--steps", "2", "--batch", "2",
           "--seq", "16"]
    for latest in (2, 4):
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=240,
                              cwd=tmp_path)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
        assert "loss:" in proc.stdout
        assert CheckpointManager(str(ckpt)).all_steps() == [2, 4][: latest // 2]
