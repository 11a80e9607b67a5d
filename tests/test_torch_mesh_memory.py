"""The vlm and encdec families' meshed programs on a 4 x 2 ("data",
"model") gloo mesh of CPU ranks, against the JAX package's
SINGLE-device results.

Llama-3.2-Vision and Seamless-M4T SMOKE in float32, the vision model's
every cross-attention ``gate`` set to 0.5 in the reference's parameters
(so on both sides: the init's 0 makes the cross blocks add exactly
nothing), the extras (``image_embeds``, ``enc_frames``) drawn with
NumPy from a seed.  The reference computes a train step
(``make_train_step``), a prefill with the extras, ``prime_memory(params,
cfg, ctx, batch)`` and 4 decode steps (``decode_step(..., memory=)``);
8 gloo ranks run the port's meshed ``default_plan`` + ``make_train_step``
and, under a prefill shape's and a decode shape's ``default_serve_plan``
and the serving-weight layout's (``tp_weights=True``),
``make_prefill_fn``, ``make_prime_fn`` and ``make_decode_fn`` in one
spawn (a script under ``tmp_path``, a ``file://`` store there, under a
300 s limit).  Bars: the loss within 1e-5 relative, the updated
parameters and the logits within 1e-4 of each tensor's largest
magnitude.  In process: the placements of ``image_embeds``,
``enc_frames`` and the memory stack are the reference's
``logical_sharding`` of the same logical axes on both production meshes.
Last, ``launch.train`` and ``launch.serve --mesh 1x1`` run both families
from the command line, their extras from ``train.StubExtras``.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import registry as ref_registry
from repro.launch import train as ref_train
from repro.models import transformer as ref_T
from repro.optim import adamw as ref_opt
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import registry
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.launch import serve, train
from repro_torch.models import frontends
from repro_torch.models import transformer as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["llama-3.2-vision-11b", "seamless-m4t-large-v2"]
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
GATE = 0.5
B, S, STEPS = 8, 16, 4
KINDS = ("prefill", "decode")
#: the spawn's serving plans: (shape kind, tp_weights)
LAYOUTS = tuple((kind, False) for kind in KINDS) + (("prefill", True),)

RANKS = textwrap.dedent('''
    import dataclasses, logging, pickle, sys
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    @dataclasses.dataclass(frozen=True)
    class Shape:
        seq_len: int
        global_batch: int
        kind: str


    def run(rank, world, store, data_path, out_path):
        torch.set_num_threads(1)
        logging.disable(logging.WARNING)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=240))
        from repro_torch.configs.registry import get_smoke
        from repro_torch.launch import serve, train
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import transformer as T
        from repro_torch.models.init import from_reference, tree_leaves, tree_map
        from repro_torch.optim import adamw as opt

        with open(data_path, "rb") as f:
            data = pickle.load(f)
        mesh = make_host_mesh(4, 2, device_type="cpu")
        out = {}
        for arch, d in data.items():
            cfg = get_smoke(arch, param_dtype="float32", compute_dtype="float32")
            logical = T.param_logical(cfg)
            extras = {k: torch.from_numpy(v) for k, v in d["extras"].items()}
            plan = train.default_plan(cfg, mesh)
            params = tree_map(lambda p, l: plan.ctx.distribute(p, l),
                              from_reference(d["params"], cfg), logical)
            state = opt.adamw_init(params, plan.opt_cfg)
            batch = {k: torch.from_numpy(v).long() for k, v in d["batch"].items()}
            params, state, metrics = train.make_train_step(plan)(params, state,
                                                                 {**batch, **extras})
            out[arch] = {"loss": float(metrics["loss"]),
                         "params": [p.full_tensor().numpy() for p in tree_leaves(params)]}
            for kind, tp in %(LAYOUTS)r:
                splan = serve.default_serve_plan(cfg, mesh, Shape(%(S)d + %(STEPS)d, %(B)d, kind),
                                                 tp_weights=tp)
                weights = tree_map(lambda p, l: splan.ctx.distribute(p, l),
                                   from_reference(d["params"], cfg), logical)
                prompt = {"tokens": torch.from_numpy(d["prompt"]).long(), **extras}
                logits, cache = serve.make_prefill_fn(splan)(weights, prompt)
                memory = serve.make_prime_fn(splan)(weights, prompt)
                decoded = [logits.full_tensor().numpy()]
                step = serve.make_decode_fn(splan)
                for i, tok in enumerate(d["steps"]):
                    lg, cache = step(weights, torch.from_numpy(tok).long(), cache, %(S)d + i,
                                     memory)
                    decoded.append(lg.full_tensor().numpy())
                out[arch]["tp_weights" if tp else kind] = decoded
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
        dist.destroy_process_group()


    if __name__ == "__main__":
        store, data_path, out_path = sys.argv[1:]
        mp.spawn(run, args=(8, store, data_path, out_path), nprocs=8)
''') % {"S": S, "STEPS": STEPS, "B": B, "LAYOUTS": LAYOUTS}


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, (err, scale)


def _set_gates(tree) -> int:
    """Set every ``gate`` leaf of a NumPy tree to GATE in place; the count."""
    n = 0
    for key, val in tree.items():
        if isinstance(val, dict):
            n += _set_gates(val)
        elif key == "gate":
            val[...] = GATE
            n += 1
    return n


def _inputs(arch):
    """The reference's initial parameters (gates at GATE), the extras, and
    the batch, prompt and decode tokens of one arch."""
    ref_cfg = ref_registry.get_smoke(arch, **F32)
    params = jax.tree.map(np.array, ref_T.init_params(ref_cfg, jax.random.PRNGKey(0)))
    assert _set_gates(params) == (1 if ref_cfg.family == "vlm" else 0)
    rng = np.random.default_rng(1)
    draw = lambda *shape: rng.integers(0, ref_cfg.vocab_size, shape).astype(np.int32)  # noqa: E731
    extras = {name: (0.02 * rng.standard_normal(shape)).astype(np.float32)
              for name, shape in frontends.frontend_shapes(
                  registry.get_smoke(arch, **F32), B).items()}
    return {"params": params, "extras": extras,
            "batch": {"tokens": draw(B, S), "labels": draw(B, S)},
            "prompt": draw(B, S), "steps": [draw(B, 1) for _ in range(STEPS)]}


def _reference(arch, d):
    """The reference's single-device train step, and its prefill,
    ``prime_memory`` and decode steps."""
    ref_cfg = ref_registry.get_smoke(arch, **F32)
    extras = {k: jnp.asarray(v) for k, v in d["extras"].items()}
    plan = ref_train.default_plan(ref_cfg)
    params = jax.tree.map(jnp.asarray, d["params"])
    state = ref_opt.adamw_init(params, plan.opt_cfg)
    new, _, metrics = ref_train.make_train_step(plan)(
        params, state, {**{k: jnp.asarray(v) for k, v in d["batch"].items()}, **extras})
    ctx = ref_sharding.ShardingCtx.none()
    params = jax.tree.map(jnp.asarray, d["params"])
    batch = {"tokens": jnp.asarray(d["prompt"]), **extras}
    logits, cache = ref_T.prefill(params, batch, ref_cfg, ctx, max_len=S + STEPS)
    memory = ref_T.prime_memory(params, ref_cfg, ctx, batch)
    decoded = [np.asarray(logits)]
    for i, tok in enumerate(d["steps"]):
        lg, cache = ref_T.decode_step(params, jnp.asarray(tok), cache, jnp.int32(S + i),
                                      ref_cfg, ctx, memory=memory)
        decoded.append(np.asarray(lg))
    return {"loss": float(metrics["loss"]),
            "params": [np.asarray(p) for p in jax.tree.leaves(new)], "logits": decoded}


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    """The 8 ranks' results and the reference's, computed meanwhile."""
    tmp = tmp_path_factory.mktemp("mesh_memory")
    data = {arch: _inputs(arch) for arch in ARCHS}
    with open(tmp / "data.pkl", "wb") as f:
        pickle.dump(data, f)
    (tmp / "ranks.py").write_text(RANKS)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, str(tmp / "ranks.py"), str(tmp / "store"),
                             str(tmp / "data.pkl"), str(tmp / "out.pkl")],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=tmp)
    try:
        want = {arch: _reference(arch, d) for arch, d in data.items()}
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, out[-4000:] + err[-8000:]
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f), want


@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_train_step_matches_single_device_reference(meshed, arch):
    got, want = meshed[0][arch], meshed[1][arch]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert len(got["params"]) == len(want["params"])
    for g, w in zip(got["params"], want["params"]):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_prefill_prime_and_decode_match_single_device_reference(meshed, arch, kind):
    """Under a prefill shape's rules and a decode shape's (the memory's
    batch over "model", its sequence over "data")."""
    got, want = meshed[0][arch][kind], meshed[1][arch]["logits"]
    assert len(got) == len(want) == STEPS + 1
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_weights_prefill_prime_and_decode_match_single_device_reference(meshed, arch):
    """Under the serving-weight layout (the image tokens' sequence, the
    memory's and the cache's on "model")."""
    got, want = meshed[0][arch]["tp_weights"], meshed[1][arch]["logits"]
    assert len(got) == len(want) == STEPS + 1
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


MESHES = {"pod": (16, 16), "multipod": (2, 16, 16)}


@dataclasses.dataclass
class _Mesh:
    """A production mesh's names and sizes: placements need no devices."""

    shape: tuple
    device_type: str = "cpu"

    @property
    def mesh_dim_names(self):
        return ("pod", "data", "model")[-len(self.shape):]


def _ref_placements(logical, names, sizes, rules):
    """DTensor placements of the reference's ``logical_sharding`` spec."""
    spec = ref_sharding.logical_sharding(logical, AbstractMesh(sizes, names), rules).spec
    dims = {a: d for d, axes in enumerate(spec) for a in ((axes,) if isinstance(axes, str)
                                                          else axes or ())}
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in names)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_extras_and_memory_placements_match_reference(arch, mesh):
    """``image_embeds`` by ("batch", None, None), ``enc_frames`` by
    ("batch", "seq", None) in the train plan and both serving plans; the
    memory stack by ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    under the serving plans' rules: the placements of the reference's
    shardings of those axes under its rules of the same plans."""
    fake = _Mesh(MESHES[mesh])
    names, sizes = fake.mesh_dim_names, fake.shape
    cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
    extra = next(iter(frontends.frontend_shapes(cfg, 1)))
    extra_logical = {"enc_frames": ("batch", "seq", None),
                     "image_embeds": ("batch", None, None)}[extra]
    plan = train.default_plan(cfg, fake)
    assert plan.batch_shardings({extra: None, "tokens": None}) == {
        extra: _ref_placements(extra_logical, names, sizes, ref_sharding.rules_for(ref_cfg)),
        "tokens": _ref_placements(("batch", "seq"), names, sizes, ref_sharding.rules_for(ref_cfg))}
    for kind in KINDS:
        splan = serve.default_serve_plan(cfg, fake, ShapeSpec("x", 64, 512, kind))
        ref_rules = ref_sharding.rules_for(ref_cfg, decode_batch=kind == "decode")
        assert splan.ctx.placements(train.batch_logical(extra)) == _ref_placements(
            extra_logical, names, sizes, ref_rules)
        want = _ref_placements(("layers", "batch", "kv_seq", "kv_heads", "head_dim"), names,
                               sizes, ref_rules)
        assert splan.ctx.placements(T.MEMORY_LOGICAL) == want
    # under the decode rules the memory's sequence lies on "data"
    decode = serve.default_serve_plan(cfg, fake, SHAPES["decode_32k"])
    assert decode.ctx.placements(T.MEMORY_LOGICAL)[names.index("data")] == Shard(2)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_and_serves_the_family_on_a_mesh(arch, tmp_path):
    """``launch.train`` and ``launch.serve --mesh 1x1`` (a world of one)
    for the family, its extras from the frontend stubs."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    runs = (("repro_torch.launch.train", ["--steps", "2", "--batch", "2", "--seq", "16"],
             "loss:"),
            ("repro_torch.launch.serve", ["--batch", "2", "--gen-len", "3"], "prefill:"))
    for module, args, said in runs:
        proc = subprocess.run([sys.executable, "-m", module, "--arch", arch, "--smoke",
                               "--device", "cpu", "--mesh", "1x1", *args], env=env,
                              capture_output=True, text=True, timeout=240, cwd=tmp_path)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
        assert said in proc.stdout


@pytest.mark.parametrize("arch", ARCHS)
def test_stub_extras_give_the_family_its_inputs(arch):
    """The command line's data: SyntheticLM's tokens and labels plus the
    family's extras (float32, 0.02 x standard normal, the same for the
    same step), which ``batch_to_device`` keeps in their type."""
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    cfg = registry.get_smoke(arch)
    data = train.StubExtras(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                                   global_batch=4)), cfg)
    batch = data.batch(3)
    (name, shape), = frontends.frontend_shapes(cfg, 4).items()
    assert sorted(batch) == sorted(["tokens", "labels", name])
    assert batch[name].shape == shape and batch[name].dtype == np.float32
    assert 0.01 < float(batch[name].std()) < 0.03
    np.testing.assert_array_equal(batch[name], data.batch(3)[name])
    assert not np.array_equal(batch[name], data.batch(4)[name])
    placed = train.batch_to_device(batch, torch.device("cpu"))
    assert placed[name].dtype == torch.float32 and placed["tokens"].dtype == torch.int64
