"""The port's examples (``repro_torch.examples``) against ``examples/*.py``.

The reference's scripts are loaded by path with ``importlib`` and left
as they are; their ``main()`` reads ``sys.argv``, which the tests set.
Real training stages take host time, which no two runs share, so the
cluster demo runs both sides with one deterministic runner in place of
each module's ``make_real_runner`` (walls from a seeded generator a job,
termination by a rule on the job and stage), and the training demo with
one stub ``Trainer`` whose ``run`` hands back a fixed loss history a
stage.  Under them both scripts must print the same lines.  One run of
the port's training demo trains for real on the CPU.
"""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest

from repro_torch.examples import cluster_schedule, train_early_termination

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_ref_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_main(monkeypatch, mod, argv):
    monkeypatch.setattr(sys, "argv", [f"{mod.__name__}.py", *argv])
    mod.main()


def deterministic_runner(arch, steps_per_stage, min_improvement, *device):
    """A runner whose stage walls are drawn from a generator seeded by the
    arch and whose stage s > 0 ends the job when (job + s) % 3 == 0."""
    rng = np.random.default_rng(sum(map(ord, arch)) + steps_per_stage)

    def runner(job, stage):
        wall = float(rng.uniform(0.5, 3.0))
        return wall, stage > 0 and (job.spec.job_id + stage) % 3 == 0

    return runner


def test_cluster_schedule_prints_what_the_reference_prints(monkeypatch, tmp_path, capsys):
    """``--jobs 6 --servers 2`` on both sides: the metrics snapshot and
    every job's status line equal, character for character.  No field is
    left out: under the deterministic runner no printed number is host
    time."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache"))
    ref = _load("cluster_schedule")
    assert ref.ARCH_POOL == cluster_schedule.ARCH_POOL
    for mod in (ref, cluster_schedule):
        monkeypatch.setattr(mod, "make_real_runner", deterministic_runner)
    argv = ["--jobs", "6", "--servers", "2", "--stages", "3", "--steps-per-stage", "3"]
    _ref_main(monkeypatch, ref, argv)
    want = capsys.readouterr().out
    res, jobs = cluster_schedule.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert "jobs.total                                   6" in got
    assert all(j.success or j.stage > 0 for j in jobs) and len(jobs) == 6
    assert {j.name.split("#")[0] for j in jobs} == set(cluster_schedule.ARCH_POOL)


def test_cluster_schedule_trains_for_real_on_the_cpu(monkeypatch, tmp_path, capsys):
    """The pool's real runners (Jamba's SMOKE config among them) on the
    CPU: every job ends as a success or terminated, with positive walls."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "cache"))
    res, jobs = cluster_schedule.main(["--jobs", "6", "--servers", "2", "--stages", "2",
                                       "--steps-per-stage", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "jamba-v0.1-52b#5" in out and res.makespan > 0
    for j in jobs:
        assert j.success or j.stage > 0
        assert j.name in out


class StubTrainer:
    """``Trainer``'s face with a fixed loss history a stage."""

    histories: list = []

    def __init__(self, plan, data, ckpt_manager=None, ckpt_every=100, **kw):
        self.stage = 0

    def run(self, steps, seed=0, log_every=10, log=print):
        hist = self.histories[self.stage]
        self.stage += 1
        return None, None, list(hist)


@pytest.mark.parametrize("stage_losses,ends", [
    ([5.0, 4.0, 3.0], "job SUCCESSFUL"),        # improves every stage
    ([5.0, 4.999, 3.0], "[stage 1] EARLY"),     # the gate stops it at stage 1
    ([5.0, 4.0, 3.999], "[stage 2] EARLY"),     # the gate stops it at stage 2
])
def test_train_early_termination_gates_as_the_reference(monkeypatch, tmp_path, capsys,
                                                        stage_losses, ends):
    """With one stub Trainer in both scripts, both print the same stage
    lines and stop at the same stage (the metric gate, early termination
    and success)."""
    ref = _load("train_early_termination")
    histories = [[loss + 0.1, loss, loss, loss, loss, loss] for loss in stage_losses]
    monkeypatch.setattr(StubTrainer, "histories", histories)
    for mod in (ref, train_early_termination):
        monkeypatch.setattr(mod, "Trainer", StubTrainer)
    argv = ["--stages", "3", "--steps-per-stage", "6"]
    _ref_main(monkeypatch, ref, argv)
    want = capsys.readouterr().out
    losses = train_early_termination.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert ends in got and losses == stage_losses[: len(losses)]


def test_train_early_termination_trains_on_the_cpu(capsys):
    losses = train_early_termination.main(["--device", "cpu", "--stages", "2",
                                           "--steps-per-stage", "3", "--batch", "2",
                                           "--seq", "32"])
    out = capsys.readouterr().out
    assert len(losses) in (1, 2) and all(np.isfinite(losses))
    assert "[stage 0] loss=" in out and "loss trajectory per stage: [" in out
    assert "model: qwen3-1.7b-smoke" in out


def _same_config(got, want) -> None:
    import dataclasses

    from repro_torch.models.config import ModelConfig

    for f in dataclasses.fields(ModelConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_tiny_preset_takes_the_kernels_head_dim_on_the_card():
    """The presets are the reference's configs on every device: tiny is
    Qwen3-1.7B's SMOKE config, whose head dim 32 the attention kernels
    take, and 100m keeps Qwen3-1.7B's head dim, 128."""
    from repro_torch.kernels.flash_attention import kernel as FK

    ref = _load("train_early_termination")
    for preset in ("tiny", "100m"):
        _same_config(train_early_termination.make_cfg(preset), ref.make_cfg(preset))
    assert train_early_termination.make_cfg("tiny").hd == 32
    assert train_early_termination.make_cfg("100m").hd == 128
    assert {32, 128} <= set(FK.KERNEL_HEAD_DIMS)
    assert not hasattr(train_early_termination, "KERNEL_HEAD_DIM")


def test_cluster_pool_takes_the_reference_configs_on_every_device(monkeypatch):
    """The pool's runners train each arch's SMOKE config as the reference's
    do, whatever the device (the plan is captured, not trained)."""
    import torch

    from repro.configs import registry as ref_registry
    from repro_torch.kernels.flash_attention import kernel as FK

    ref = _load("cluster_schedule")
    assert cluster_schedule.ARCH_POOL == ref.ARCH_POOL
    seen = []

    class _Trainer:
        def __init__(self, plan, data, ckpt):
            seen.append(plan.cfg)

    monkeypatch.setattr(cluster_schedule, "Trainer", _Trainer)
    monkeypatch.setattr(cluster_schedule, "default_plan",
                        lambda cfg, device: type("P", (), {"cfg": cfg})())
    monkeypatch.setattr(cluster_schedule, "resolve_device", lambda d: torch.device("cuda"))
    for arch in cluster_schedule.ARCH_POOL:
        cluster_schedule.make_real_runner(arch, 1, 0.0)
        _same_config(seen[-1], ref_registry.get_smoke(arch))
        assert not seen[-1].n_heads or seen[-1].hd in FK.KERNEL_HEAD_DIMS
