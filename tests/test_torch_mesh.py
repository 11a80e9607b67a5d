"""The meshed programs on a 4 x 2 ("data", "model") gloo mesh of CPU ranks,
against the JAX package's SINGLE-device results.

The reference's numbers (a train step, a prefill and 4 decode steps, for
qwen3-1.7b, mixtral-8x22b, mamba2-1.3b and jamba-v0.1-52b SMOKE in
float32; ``ref_attention`` at four cache lengths) are computed here and
handed to 8 gloo ranks, which run the port's meshed programs
(``default_plan`` + ``make_train_step``, ``default_serve_plan`` +
``make_prefill_fn`` / ``make_decode_fn``, in the default and the
serving-weight layout, ``sp_decode_attention``) in
one spawn: a script under ``tmp_path``, its ranks joined through a
``file://`` store there (never a TCP port: other test workers run at the
same time), the whole spawn under a 300 s limit.  Bars: the loss within
1e-5 relative, the updated parameters and the logits within 1e-4 of each
tensor's largest magnitude, ``sp_decode_attention`` within 1e-5 (the
reference's own bar, ``tests/test_sharding.py:147``).
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

from repro.configs import registry as ref_registry
from repro.kernels.flash_attention.ref import ref_attention
from repro.launch import train as ref_train
from repro.models import transformer as ref_T
from repro.optim import adamw as ref_opt
from repro.parallel.sharding import ShardingCtx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen3-1.7b", "mixtral-8x22b", "mamba2-1.3b", "jamba-v0.1-52b"]
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
B, S, STEPS = 8, 16, 4
KV_LENS = (1, 17, 33, 64)

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
        kind: str = "prefill"


    def run(rank, world, store, data_path, out_path):
        torch.set_num_threads(1)
        logging.disable(logging.WARNING)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=240))
        from repro_torch.configs.registry import get_smoke
        from repro_torch.launch import serve, train
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import transformer as T
        from repro_torch.models.attention import sp_decode_attention
        from repro_torch.models.init import from_reference, tree_leaves, tree_map
        from repro_torch.optim import adamw as opt
        from repro_torch.parallel.sharding import LONG_CONTEXT_RULES, ShardingCtx

        with open(data_path, "rb") as f:
            data = pickle.load(f)
        mesh = make_host_mesh(4, 2, device_type="cpu")
        out = {}
        for arch, d in data["archs"].items():
            cfg = get_smoke(arch, param_dtype="float32", compute_dtype="float32")
            logical = T.param_logical(cfg)
            plan = train.default_plan(cfg, mesh)
            params = tree_map(lambda p, l: plan.ctx.distribute(p, l),
                              from_reference(d["params"], cfg), logical)
            state = opt.adamw_init(params, plan.opt_cfg)
            batch = {k: torch.from_numpy(v).long() for k, v in d["batch"].items()}
            params, state, metrics = train.make_train_step(plan)(params, state, batch)
            new = [p.full_tensor().numpy() for p in tree_leaves(params)]
            splan = serve.default_serve_plan(cfg, mesh, Shape(%(S)d + %(STEPS)d, %(B)d))
            weights = tree_map(lambda p, l: splan.ctx.distribute(p, l),
                               from_reference(d["params"], cfg), logical)
            logits, cache = serve.make_prefill_fn(splan)(
                weights, {"tokens": torch.from_numpy(d["prompt"]).long()})
            decoded = [logits.full_tensor().numpy()]
            step = serve.make_decode_fn(splan)
            for i, tok in enumerate(d["steps"]):
                lg, cache = step(weights, torch.from_numpy(tok).long(), cache, %(S)d + i)
                decoded.append(lg.full_tensor().numpy())
            out[arch] = {"loss": float(metrics["loss"]), "params": new, "logits": decoded}
            # the serving-weight layout: the same prefill and decode steps
            tplan = serve.default_serve_plan(cfg, mesh, Shape(%(S)d + %(STEPS)d, %(B)d),
                                             tp_weights=True)
            weights = tree_map(lambda p, l: tplan.ctx.distribute(p, l),
                               from_reference(d["params"], cfg), logical)
            logits, cache = serve.make_prefill_fn(tplan)(
                weights, {"tokens": torch.from_numpy(d["prompt"]).long()})
            decoded = [logits.full_tensor().numpy()]
            step = serve.make_decode_fn(tplan)
            for i, tok in enumerate(d["steps"]):
                lg, cache = step(weights, torch.from_numpy(tok).long(), cache, %(S)d + i)
                decoded.append(lg.full_tensor().numpy())
            out[arch]["tp_logits"] = decoded

        ctx = ShardingCtx(mesh, LONG_CONTEXT_RULES)
        q, k, v = (torch.from_numpy(a) for a in data["attention"]["qkv"])
        qd = ctx.distribute(q, ("batch", None, "act_heads", "head_dim"))
        kd, vd = (ctx.distribute(t, ("batch", "kv_seq", "kv_heads", "head_dim")) for t in (k, v))
        out["sp_decode"] = [sp_decode_attention(qd, kd, vd, n, ctx).full_tensor().numpy()
                            for n in data["attention"]["kv_lens"]]
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
        dist.destroy_process_group()


    if __name__ == "__main__":
        store, data_path, out_path = sys.argv[1:]
        mp.spawn(run, args=(8, store, data_path, out_path), nprocs=8)
''') % {"S": S, "STEPS": STEPS, "B": B}


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, (err, scale)


def _inputs(arch):
    """The reference's initial parameters and the batch, prompt and decode
    tokens of one arch (both sides take the same decode tokens)."""
    ref_cfg = ref_registry.get_smoke(arch, **F32)
    params = jax.tree.map(np.asarray, ref_T.init_params(ref_cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    draw = lambda *shape: rng.integers(0, ref_cfg.vocab_size, shape).astype(np.int32)  # noqa: E731
    return {"params": params, "batch": {"tokens": draw(B, S), "labels": draw(B, S)},
            "prompt": draw(B, S), "steps": [draw(B, 1) for _ in range(STEPS)]}


def _reference(arch, d):
    """The reference's single-device train step, prefill and decode steps."""
    ref_cfg = ref_registry.get_smoke(arch, **F32)
    plan = ref_train.default_plan(ref_cfg)
    params = jax.tree.map(jnp.asarray, d["params"])
    state = ref_opt.adamw_init(params, plan.opt_cfg)
    new, _, metrics = ref_train.make_train_step(plan)(
        params, state, {k: jnp.asarray(v) for k, v in d["batch"].items()})
    ctx = ShardingCtx.none()
    params = jax.tree.map(jnp.asarray, d["params"])
    logits, cache = ref_T.prefill(params, {"tokens": jnp.asarray(d["prompt"])}, ref_cfg, ctx,
                                  max_len=S + STEPS)
    decoded = [np.asarray(logits)]
    for i, tok in enumerate(d["steps"]):
        lg, cache = ref_T.decode_step(params, jnp.asarray(tok), cache, jnp.int32(S + i),
                                      ref_cfg, ctx)
        decoded.append(np.asarray(lg))
    return {"loss": float(metrics["loss"]),
            "params": [np.asarray(p) for p in jax.tree.leaves(new)], "logits": decoded}


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    """The 8 ranks' results and the reference's, computed meanwhile."""
    tmp = tmp_path_factory.mktemp("mesh")
    data = {"archs": {arch: _inputs(arch) for arch in ARCHS}}
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((1, 1, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32)))
    data["attention"] = {"qkv": (q, k, v), "kv_lens": KV_LENS}
    with open(tmp / "data.pkl", "wb") as f:
        pickle.dump(data, f)
    (tmp / "ranks.py").write_text(RANKS)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, str(tmp / "ranks.py"), str(tmp / "store"),
                             str(tmp / "data.pkl"), str(tmp / "out.pkl")],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=tmp)
    try:
        want = {arch: _reference(arch, d) for arch, d in data["archs"].items()}
        want["sp_decode"] = [np.asarray(ref_attention(jnp.asarray(q), jnp.asarray(k),
                                                      jnp.asarray(v), causal=False,
                                                      kv_len=jnp.int32(n))) for n in KV_LENS]
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


@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_prefill_and_decode_match_single_device_reference(meshed, arch):
    got, want = meshed[0][arch]["logits"], meshed[1][arch]["logits"]
    assert len(got) == len(want) == STEPS + 1
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_weights_prefill_and_decode_match_single_device_reference(meshed, arch):
    """``default_serve_plan(tp_weights=True)``: the weights tensor-parallel
    over "model" only, the batch over "data", the cache's sequence over
    "model" (``sp_decode_attention`` combines over "model")."""
    got, want = meshed[0][arch]["tp_logits"], meshed[1][arch]["logits"]
    assert len(got) == len(want) == STEPS + 1
    for g, w in zip(got, want):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("i", range(len(KV_LENS)), ids=[f"kv_len={n}" for n in KV_LENS])
def test_sp_decode_attention_matches_reference(meshed, i):
    got, want = meshed[0]["sp_decode"][i], meshed[1]["sp_decode"][i]
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) < 1e-5


def test_meshed_plan_refuses_what_is_not_wired():
    """Meshed adafactor raises (as the reference refuses it); the vlm and
    encdec families' meshed train and serve plans build; the unmeshed plan
    keeps its device."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import serve, train
    from repro_torch.optim import adamw as opt

    class _Mesh:
        mesh_dim_names = ("data", "model")
        shape = (1, 1)
        device_type = "cpu"

    cfg = registry.get_smoke("qwen3-1.7b")
    plan = train.default_plan(cfg, _Mesh(), opt_cfg=opt.OptConfig(kind="adafactor"))
    with pytest.raises(NotImplementedError, match="adafactor"):
        train.make_train_step(plan)
    for arch in ("llama-3.2-vision-11b", "seamless-m4t-large-v2"):
        meshed = train.default_plan(registry.get_smoke(arch), _Mesh())
        assert meshed.mesh is not None and meshed.device == torch.device("cpu")
        splan = serve.ServePlan(cfg=registry.get_smoke(arch), max_len=8,
                                device=torch.device("cpu"), mesh=_Mesh())
        assert splan.ctx.mesh is not None
    assert train.default_plan(cfg, device="cpu").device == torch.device("cpu")
    assert dataclasses.replace(plan, mesh=None).ctx.mesh is None
