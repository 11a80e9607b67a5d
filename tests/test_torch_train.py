"""Port parity of the training path: the loss and its gradients, the
optimizers and schedules, the data pipeline, checkpoints and the trainer.

The same inputs go through the JAX package and through the port on the
CPU (kernels' plain versions); parameters are carried across with
``from_reference`` or through a checkpoint that ``repro`` wrote.
Tolerances, float32 unless a test says otherwise:

* ``lm_loss`` and every gradient leaf against ``jax.value_and_grad`` of
  the reference's ``lm_loss``: 1e-5 relative for the loss, 1e-4 of each
  leaf's largest magnitude for the gradients (float32 products and sums
  in another order through a few layers and the backward);
* one or two optimizer steps on identical gradients: 1e-6 of each
  tensor's largest magnitude in float32 (the same float32 arithmetic,
  reductions in another order), one bf16 ulp (2**-8 relative) where the
  parameter or moment is bf16;
* the schedules to 1e-6 (float32 on both sides; ``cos`` may round
  differently); data batches bitwise; checkpoints bitwise;
* a 3-step Trainer run's losses to 1e-5 relative.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import registry as ref_registry
from repro.data import pipeline as ref_pipeline
from repro.launch import train as ref_train
from repro.models import transformer as ref_T
from repro.optim import adamw as ref_opt
from repro.optim import schedule as ref_schedule
from repro.parallel.sharding import ShardingCtx
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.models.init import from_reference, tree_leaves, tree_map
from repro_torch.optim import adamw as opt
from repro_torch.optim import schedule

F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
FAMILIES = ["qwen3-1.7b", "mixtral-8x22b", "mamba2-1.3b"]  # dense, moe, ssm


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want)))
    assert float(np.max(np.abs(got - want))) <= rtol * scale, (
        float(np.max(np.abs(got - want))), scale)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _batch(cfg, b, s, step=0, seed=0):
    data = pipeline.SyntheticLM(pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                                    global_batch=b, seed=seed))
    return data.batch(step)


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_loss_and_gradients_match_reference(arch):
    ref_cfg, cfg = ref_registry.get_smoke(arch, **F32), registry.get_smoke(arch, **F32)
    ref_params = ref_T.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg)
    batch = _batch(cfg, 2, 16)

    def loss_ref(p):
        return ref_T.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, ref_cfg,
                             ShardingCtx.none())

    (loss_want, metrics_want), grads_want = jax.value_and_grad(loss_ref, has_aux=True)(
        ref_params)
    loss, metrics, grads = train.loss_and_grads(params, _torch_batch(batch), cfg)
    np.testing.assert_allclose(float(loss), float(loss_want), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(metrics_want["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(metrics_want["aux"]), rtol=1e-5,
                               atol=1e-7)
    got, want = tree_leaves(grads), jax.tree.leaves(grads_want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(_np(g), np.asarray(w), 1e-4)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_the_gradients(remat):
    """Recomputing the blocks in the backward changes nothing: the loss
    and every gradient equal those of remat="none", bit for bit."""
    cfg = registry.get_smoke("qwen3-1.7b", **F32)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _torch_batch(_batch(cfg, 2, 16))
    loss0, _, g0 = train.loss_and_grads(params, batch, cfg)
    loss1, _, g1 = train.loss_and_grads(params, batch, dataclasses.replace(cfg, remat=remat))
    assert float(loss0) == float(loss1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        assert torch.equal(a, b)


def test_chunked_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal((16, 64)).astype(np.float32)
    labels = rng.integers(-1, 64, (2, 5)).astype(np.int32)
    from repro.models import layers as ref_layers
    from repro_torch.models import layers

    want = ref_layers.chunked_cross_entropy(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
                                            None, 16)
    got = layers.chunked_cross_entropy(torch.tensor(x), torch.tensor(w),
                                       torch.tensor(labels), None, 16)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    full = layers.cross_entropy(torch.tensor(x) @ torch.tensor(w), torch.tensor(labels))
    np.testing.assert_allclose(float(full), float(want), rtol=1e-6)


@pytest.mark.parametrize("remat,fwd_per_layer", [("none", 1), ("full", 2)])
def test_train_step_runs_each_attention_kernel_per_layer(remat, fwd_per_layer, monkeypatch):
    """The kernels' call pattern of one step of 2 micro-batches: the
    forward once a layer and micro-batch (twice under remat="full", which
    recomputes each block in the backward), flash_dkv and flash_dq once.
    Counted on the plain versions the wrappers call on the CPU."""
    calls = {"fwd": 0, "dkv": 0, "dq": 0}
    for name, key in (("flash_fwd_torch", "fwd"), ("flash_dkv_torch", "dkv"),
                      ("flash_dq_torch", "dq")):
        fn = getattr(FK, name)

        def counting(*args, fn=fn, key=key, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(FK, name, counting)
    cfg = registry.get_smoke("qwen3-1.7b", remat=remat)
    plan = train.default_plan(cfg, device="cpu", accum_steps=2)
    params, state = train.make_init(plan)(0)
    train.make_train_step(plan)(params, state, _torch_batch(_batch(cfg, 4, 16)))
    n = cfg.n_layers * 2
    assert calls == {"fwd": fwd_per_layer * n, "dkv": n, "dq": n}


# ---------------------------------------------------------------------------
# Optimizers and schedules
# ---------------------------------------------------------------------------


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 130)).astype(np.float32),
            "b": {"c": rng.standard_normal((3,)).astype(np.float32),
                  "w": rng.standard_normal((2, 130, 129)).astype(np.float32)}}


OPT_CASES = [
    pytest.param(ref_opt.OptConfig(), id="adamw"),
    pytest.param(ref_opt.OptConfig(clip_norm=0.5), id="adamw-clipped"),
    pytest.param(ref_opt.OptConfig(clip_norm=1e3), id="adamw-unclipped"),
    pytest.param(ref_opt.OptConfig(moment_dtype="bfloat16"), id="adamw-bf16-moments"),
    pytest.param(ref_opt.OptConfig(kind="adafactor", factored_min_size=128), id="adafactor"),
    pytest.param(ref_opt.OptConfig(kind="adafactor", moment_dtype="bfloat16",
                                   factored_min_size=4), id="adafactor-bf16-moments"),
]


@pytest.mark.parametrize("ref_cfg", OPT_CASES)
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(ref_cfg, param_dtype):
    cfg = opt.OptConfig(**dataclasses.asdict(ref_cfg))
    p_np = _opt_tree(0)
    jdt = jnp.dtype(param_dtype)
    ref_params = jax.tree.map(lambda a: jnp.asarray(a, jdt), p_np)
    params = tree_map(lambda a: torch.tensor(np.asarray(jnp.asarray(a, jdt), np.float32))
                      .to(getattr(torch, param_dtype)), p_np)
    init, ref_init = ((opt.adafactor_init, ref_opt.adafactor_init) if cfg.kind == "adafactor"
                      else (opt.adamw_init, ref_opt.adamw_init))
    ref_state, state = ref_init(ref_params, ref_cfg), init(params, cfg)
    for step in range(2):
        g_np = tree_map(lambda a: 3 * a, _opt_tree(10 + step))
        lr_scale = 0.5 + step
        ref_params, ref_state = ref_opt.apply_updates(
            ref_params, jax.tree.map(jnp.asarray, g_np), ref_state, ref_cfg, lr_scale)
        state = opt.apply_updates(params, tree_map(torch.tensor, g_np), state, cfg, lr_scale)
    assert state.step == int(ref_state.step) == 2
    pairs = list(zip(tree_leaves(params), jax.tree.leaves(ref_params)))
    for mine, theirs in ((state.mu, ref_state.mu), (state.nu, ref_state.nu)):
        flat = [t for leaf in tree_leaves(mine)
                for t in (leaf if isinstance(leaf, tuple) else (leaf,))]
        pairs += list(zip(flat, jax.tree.leaves(theirs)))
    for got, want in pairs:
        rtol = 2.0**-8 if got.dtype == torch.bfloat16 else 1e-6
        _close(_np(got), np.asarray(want, np.float32), rtol)


def test_global_norm_matches_reference():
    tree = _opt_tree(5)
    np.testing.assert_allclose(float(opt.global_norm(tree_map(torch.tensor, tree))),
                               float(ref_opt.global_norm(jax.tree.map(jnp.asarray, tree))),
                               rtol=1e-6)


@pytest.mark.parametrize("warmup,total", [(10, 100), (1, 3), (0, 50)])
def test_schedules_match_reference(warmup, total):
    for step in range(0, total + 20):
        np.testing.assert_allclose(schedule.linear_warmup(step, warmup),
                                   float(ref_schedule.linear_warmup(jnp.int32(step), warmup)),
                                   rtol=1e-6)
        np.testing.assert_allclose(schedule.cosine_schedule(step, warmup, total),
                                   float(ref_schedule.cosine_schedule(jnp.int32(step), warmup,
                                                                      total)),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed,step", [(512, 64, 4, 0, 0), (151936, 33, 3, 7, 5),
                                                       (100, 16, 2, 3, 1000)])
def test_synthetic_lm_equals_reference(vocab, seq, batch, seed, step):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    got = pipeline.SyntheticLM(pipeline.DataConfig(**kw)).batch(step)
    want = ref_pipeline.SyntheticLM(ref_pipeline.DataConfig(**kw)).batch(step)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for key in got:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_token_file_dataset_equals_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, 5000).astype(np.int32).tofile(path)
    kw = dict(vocab_size=1000, seq_len=32, global_batch=4, seed=2)
    for step in (0, 9):
        got = pipeline.TokenFileDataset(str(path), pipeline.DataConfig(**kw)).batch(step)
        want = ref_pipeline.TokenFileDataset(str(path), ref_pipeline.DataConfig(**kw)).batch(step)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[key], want[key])


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _state_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"embed": {"tok": torch.randn(6, 4, generator=g).to(torch.bfloat16)},
              "layers": {"w": torch.randn(2, 3, 5, generator=g)}}
    factored = (torch.rand(6, generator=g), torch.rand(4, generator=g))
    state = opt.OptState(step=7, mu=tree_map(lambda p: torch.randn(p.shape, generator=g), params),
                         nu={"embed": {"tok": factored},
                             "layers": {"w": torch.rand(2, 3, 5, generator=g)}})
    return {"params": params, "opt": state}


def _assert_trees_equal(got, want):
    from repro_torch.ckpt.checkpoint import _named_leaves

    g_leaves, w_leaves = _named_leaves(got), _named_leaves(want)
    assert [n for n, _ in g_leaves] == [n for n, _ in w_leaves]
    for (name, a), (_, b) in zip(g_leaves, w_leaves):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        else:
            assert a == b, name


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _state_tree()
    for step in range(1, 6):
        mgr.save(step, tree, blocking=step == 5)
    mgr.wait()
    assert mgr.all_steps() == [4, 5] and mgr.latest_step() == 5
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    assert sorted(os.listdir(tmp_path)) == ["step_4.json", "step_4.npz", "step_5.json",
                                             "step_5.npz"]
    target = tree_map(lambda t: torch.empty_like(t, device="meta"), _state_tree(1)["params"])
    restored = mgr.restore(5, {"params": target, "opt": _state_tree(1)["opt"]}, device="cpu")
    _assert_trees_equal(restored, tree)


def test_checkpoint_save_copies_before_returning(tmp_path):
    """The trainer updates its parameters in place right after a save: the
    checkpoint holds the values at the save."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _state_tree()
    want = tree_map(lambda t: t.clone(), tree["params"])
    mgr.save(1, tree)
    tree_map(lambda t: t.add_(1), tree["params"])
    got = mgr.restore(1, tree)
    _assert_trees_equal(got["params"], want)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A checkpoint that ``repro`` wrote of its SMOKE params and AdamW state
    (bf16 parameters as raw 2-byte data) restores into the port's tree."""
    ref_cfg, cfg = ref_registry.get_smoke("qwen3-1.7b"), registry.get_smoke("qwen3-1.7b")
    ref_plan = ref_train.default_plan(ref_cfg)
    ref_params, ref_state = ref_train.make_init(ref_plan)(jax.random.PRNGKey(0))
    RefCheckpointManager(str(tmp_path)).save(3, {"params": ref_params, "opt": ref_state},
                                             blocking=True)
    plan = train.default_plan(cfg, device="cpu")
    params, state = train._abstract_state(plan)
    tree = CheckpointManager(str(tmp_path)).restore(3, {"params": params, "opt": state},
                                                    device="cpu")
    assert tree["opt"].step == 0
    want = jax.tree.leaves(ref_params) + jax.tree.leaves(ref_state.mu) + jax.tree.leaves(
        ref_state.nu)
    got = tree_leaves(tree["params"]) + tree_leaves(tree["opt"].mu) + tree_leaves(tree["opt"].nu)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == getattr(torch, str(w.dtype))
        np.testing.assert_array_equal(_np(g), np.asarray(w, np.float32))


# ---------------------------------------------------------------------------
# Trainer and the command line
# ---------------------------------------------------------------------------


def _data(cfg):
    return pipeline.SyntheticLM(pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                                    global_batch=4))


def test_trainer_matches_reference(tmp_path):
    """Both trainers restore the same reference-written step-0 state and run
    3 steps of 2 micro-batches over the same batches."""
    ref_cfg = ref_registry.get_smoke("qwen3-1.7b", **F32)
    cfg = registry.get_smoke("qwen3-1.7b", **F32)
    kw = dict(accum_steps=2, warmup_steps=1, total_steps=3)
    ref_plan = ref_train.default_plan(ref_cfg, **kw)
    ref_params, ref_state = ref_train.make_init(ref_plan)(jax.random.PRNGKey(0))
    for d in ("ref", "port"):
        RefCheckpointManager(str(tmp_path / d)).save(0, {"params": ref_params, "opt": ref_state},
                                                     blocking=True)
    ref_data = ref_pipeline.SyntheticLM(ref_pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=4))
    _, _, want = ref_train.Trainer(ref_plan, ref_data, RefCheckpointManager(
        str(tmp_path / "ref"))).run(3, log_every=0)
    trainer = train.Trainer(train.default_plan(cfg, device="cpu", **kw), _data(cfg),
                            CheckpointManager(str(tmp_path / "port")))
    _, _, got = trainer.run(3, log_every=0)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert [r["step"] for r in trainer.records] == [0, 1, 2]
    assert all(np.isfinite(r["grad_norm"]) for r in trainer.records)


def test_restart_resumes_at_the_saved_step(tmp_path):
    cfg = registry.get_smoke("qwen3-1.7b", **F32)
    plan = train.default_plan(cfg, device="cpu", warmup_steps=1, total_steps=4)
    _, _, straight = train.Trainer(plan, _data(cfg)).run(3, log_every=0)
    first = train.Trainer(plan, _data(cfg), CheckpointManager(str(tmp_path)))
    first.run(2, log_every=0)
    second = train.Trainer(plan, _data(cfg), CheckpointManager(str(tmp_path)))
    _, _, resumed = second.run(1, log_every=0)
    assert [r["step"] for r in second.records] == [2]
    assert resumed == straight[2:]
    assert CheckpointManager(str(tmp_path)).latest_step() == 3


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    out = train.main(["--smoke", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq",
                      "16", "--ckpt-dir", str(tmp_path)])
    assert len(out["history"]) == 2 and np.all(np.isfinite(out["history"]))
    assert "loss:" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path)).latest_step() == 2


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.default_plan(registry.get_smoke("qwen3-1.7b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--smoke", "--steps", "1"])
