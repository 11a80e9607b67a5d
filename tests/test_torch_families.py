"""Port parity of the hybrid (Jamba), vlm (Llama-3.2-Vision) and encdec
(Seamless-M4T) families against ``repro`` on the CPU.

The reference's ``init_params(cfg, PRNGKey(0))`` goes across as NumPy
through ``from_reference``, with every cross-attention ``gate`` set to
0.5 on both sides first: the reference initialises the gates to 0, and
at 0 the vision model's cross blocks add exactly nothing, so a fault
there would not show.  The same NumPy tokens, image embeddings and
frame embeddings go through both packages in float32; the port's
kernels (``flash_fwd``, ``flash_dkv``, ``flash_dq``, ``ssd_fwd``,
``moe_ffn_fwd``) run their plain versions.  Tolerances are relative to
the largest magnitude of the reference's value: 1e-4 for hidden states,
logits, caches, memory and gradients (float32 products and sums in
another order over a few layers), 1e-5 for the loss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import frontends as ref_frontends
from repro.models import transformer as ref_T
from repro.parallel.sharding import ShardingCtx
from repro_torch.configs import registry
from repro_torch.launch import serve, train
from repro_torch.models import frontends
from repro_torch.models import transformer as T
from repro_torch.models.init import from_reference, tree_leaves, tree_map

RTOL = 1e-4
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
FAMILY_ARCHS = ["jamba-v0.1-52b", "llama-3.2-vision-11b", "seamless-m4t-large-v2"]
GATE = 0.5
#: Prompt tokens: a whole number of the Mamba SMOKE chunks (8), as the scan
#: requires.
S = 16


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.max(np.abs(want)))
    assert float(np.max(np.abs(got - want))) <= rtol * scale, (
        float(np.max(np.abs(got - want))), scale)


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


def _pair(arch, **overrides):
    """(reference cfg, port cfg, reference params, port params), the gates
    at GATE on both sides."""
    ref_cfg = ref_registry.get_smoke(arch, **F32, **overrides)
    cfg = registry.get_smoke(arch, **F32, **overrides)
    flat = jax.tree.map(np.array, ref_T.init_params(ref_cfg, jax.random.PRNGKey(0)))
    gates = _set_gates(flat)
    assert gates == (1 if cfg.family == "vlm" else 0)
    return ref_cfg, cfg, jax.tree.map(jnp.asarray, flat), from_reference(flat, cfg)


def _inputs(cfg, b, s, seed=0) -> dict:
    """NumPy tokens (B, S) and the family's extras, float32."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    for name, shape in frontends.frontend_shapes(cfg, b).items():
        out[name] = (0.02 * rng.standard_normal(shape)).astype(np.float32)
    return out


def _ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_matches_reference(arch):
    ref_cfg, cfg, ref_params, params = _pair(arch)
    batch = _inputs(cfg, 2, S)
    want, want_aux, _ = ref_T.forward(ref_params, _ref(batch), ref_cfg, ShardingCtx.none())
    got, aux, caches = T.forward(params, _port(batch), cfg, mode="train")
    assert caches is None
    _close(got.numpy(), want)
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * max(abs(float(want_aux)), 1.0)
    assert (float(aux) > 0) == (cfg.n_experts > 0)


def _same_tree(got: dict, want: dict, path=""):
    assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
    for key, val in got.items():
        if isinstance(val, dict):
            _same_tree(val, want[key], f"{path}/{key}")
        else:
            _close(val.float().numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_prime_memory_and_decode_match_reference(arch):
    """The slice as a whole: prefill logits and every cache leaf, the
    primed cross memory, then 8 decode steps, against the reference."""
    ref_cfg, cfg, ref_params, params = _pair(arch)
    ctx = ShardingCtx.none()
    b, s, steps = 2, S, 8
    max_len = s + steps
    batch = _inputs(cfg, b, s)
    want_logits, want_cache = ref_T.prefill(ref_params, _ref(batch), ref_cfg, ctx, max_len)
    plan = serve.ServePlan(cfg=cfg, max_len=max_len, device=torch.device("cpu"))
    logits, cache = serve.make_prefill_fn(plan)(params, _port(batch))
    assert logits.shape == (b, s, cfg.padded_vocab) and logits.dtype == torch.float32
    _close(logits.numpy(), want_logits)
    _same_tree(cache, want_cache)

    want_mem = ref_T.prime_memory(ref_params, ref_cfg, ctx, _ref(batch))
    with torch.inference_mode():
        memory = T.prime_memory(params, cfg, _port(batch))
    if cfg.family == "hybrid":
        assert memory is None and want_mem is None
    else:
        n = cfg.n_layers // (cfg.cross_attn_period or 1)
        assert memory[0].shape == (n, b, batch.get("image_embeds", batch.get("enc_frames"))
                                   .shape[1], cfg.n_kv_heads, cfg.hd)
        for got, want in zip(memory, want_mem, strict=True):
            _close(got.numpy(), want)

    decode = serve.make_decode_fn(plan)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, steps)).astype(np.int32)
    for i in range(steps):
        want, want_cache = ref_T.decode_step(ref_params, jnp.asarray(toks[:, i : i + 1]),
                                             want_cache, jnp.int32(s + i), ref_cfg, ctx,
                                             memory=want_mem)
        got, cache = decode(params, torch.from_numpy(toks[:, i : i + 1]).long(), cache, s + i,
                            memory)
        assert got.shape == (b, 1, cfg.padded_vocab)
        _close(got.numpy(), want)
    _same_tree(cache, want_cache)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_lm_loss_and_gradients_match_reference(arch):
    ref_cfg, cfg, ref_params, params = _pair(arch)
    batch = _inputs(cfg, 2, S, seed=2)
    batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
    batch["labels"][:, -1] = -1

    def loss_ref(p):
        return ref_T.lm_loss(p, _ref(batch), ref_cfg, ShardingCtx.none())

    (loss_want, metrics_want), grads_want = jax.value_and_grad(loss_ref, has_aux=True)(
        ref_params)
    loss, metrics, grads = train.loss_and_grads(params, _port(batch), cfg)
    np.testing.assert_allclose(float(loss), float(loss_want), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(metrics_want["aux"]), rtol=1e-5,
                               atol=1e-7)
    got, want = tree_leaves(grads), jax.tree.leaves(grads_want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.detach().float().numpy(), np.asarray(w))
    if cfg.family == "vlm":  # the live gate has a gradient
        assert float(grads["periods"]["pos0"]["attn"]["gate"].abs().min()) > 0


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_the_gradients_of_the_hybrid(remat):
    """Recomputing each period in the backward changes nothing for the
    hybrid SMOKE config: the loss and every gradient equal those of
    remat="none", bit for bit."""
    cfg = registry.get_smoke("jamba-v0.1-52b", **F32)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _port(_inputs(cfg, 2, S, seed=3))
    batch["labels"] = batch["tokens"].roll(-1, dims=1)
    loss0, _, g0 = train.loss_and_grads(params, batch, cfg)
    loss1, _, g1 = train.loss_and_grads(params, batch, dataclasses.replace(cfg, remat=remat))
    assert float(loss0) == float(loss1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", sorted(ref_registry.ARCHS))
def test_init_cache_shapes_match_reference(arch):
    """Every full config's zeroed serving cache: the same tree, shapes and
    dtypes as the reference's (the port's on the meta device)."""
    ref_cfg, cfg = ref_registry.get_config(arch), registry.get_config(arch)
    want = jax.eval_shape(lambda: ref_T.init_cache(ref_cfg, 2, 24))
    got = T.init_cache(cfg, 2, 24, "meta")
    shapes = tree_map(lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), got)
    want_shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), want)
    assert shapes == want_shapes


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "seamless-m4t-large-v2"])
def test_frontend_stubs_match_reference_shapes(arch):
    cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
    assert frontends.frontend_shapes(cfg, 3) == ref_frontends.frontend_shapes(ref_cfg, 3)
    smoke, ref_smoke = registry.get_smoke(arch), ref_registry.get_smoke(arch)
    (name, shape), = frontends.frontend_shapes(smoke, 3).items()
    want = (ref_frontends.audio_frames_stub if name == "enc_frames"
            else ref_frontends.image_embeds_stub)(jax.random.PRNGKey(0), ref_smoke, 3)
    got = frontends.make_extras(torch.Generator().manual_seed(0), smoke, 3)[name]
    assert tuple(got.shape) == tuple(want.shape) == shape and got.dtype == torch.bfloat16
    # 0.02 x a standard normal, as the reference's
    assert abs(float(got.float().std()) - 0.02) < 2e-3
    assert frontends.make_extras(torch.Generator(), registry.get_smoke("qwen3-8b"), 3) == {}


def test_decode_needs_memory_for_cross_attention():
    cfg = registry.get_smoke("seamless-m4t-large-v2", **F32)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = T.init_cache(cfg, 1, 4, "cpu")
    with pytest.raises(ValueError, match="prime_memory"):
        T.decode_step(params, torch.zeros((1, 1), dtype=torch.long), cache, 0, cfg)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_generate_first_decode_equals_longer_prefill(arch):
    """Greedy generation with each family's SMOKE config on the CPU, the
    extras from the frontend stubs: the first decode step's logits equal
    the last logits of a prefill of the prompt plus the first new token
    with the same extras.  The prompt (7 tokens) and the longer one (8)
    are each within one Mamba chunk, as the scan requires."""
    cfg = registry.get_smoke(arch, **F32)
    gen = torch.Generator().manual_seed(1)
    params = T.init_params(cfg, gen, "cpu")
    if cfg.family == "vlm":
        params["periods"]["pos0"]["attn"]["gate"].fill_(GATE)
    extras = frontends.make_extras(gen, cfg, 3)
    prompts = torch.randint(0, cfg.vocab_size, (3, 7), generator=gen)
    plan = serve.ServePlan(cfg=cfg, max_len=12, device=torch.device("cpu"))
    res = serve.generate(plan, params, prompts, gen_len=5, extras=extras)
    assert res.tokens.shape == (3, 5) and int(res.tokens.max()) < cfg.vocab_size
    longer = torch.cat([prompts, res.tokens[:, :1]], dim=1)
    want, _ = T.prefill(params, {"tokens": longer, **extras}, cfg, 12)
    _close(res.first_decode_logits.numpy(), want[:, -1].numpy())
