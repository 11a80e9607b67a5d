"""Port parity of the models and their serving path: the dense family
(Qwen3 SMOKE), the ssm family (Mamba2 SMOKE) and the moe family
(Mixtral and Kimi-K2 SMOKE); the configs and parameter specs of all ten
architectures (the hybrid, vlm and encdec families' forward, serving
and training are in ``test_torch_families.py``).

The JAX package's parameters (``repro.models.transformer.init_params``)
are carried across with ``from_reference``; the same NumPy prompts go
through ``repro``'s ``prefill`` / ``decode_step`` (``ShardingCtx.none()``,
the SMOKE configs' ``*_impl="xla"``) and through the port on the CPU,
whose kernels (``flash_fwd``, ``ssd_fwd``, ``moe_ffn_fwd``) run their
plain versions.  In float32 the logits and the cache agree to 1e-4
relative to their largest magnitude (float32 products and sums in
another order over a few layers).  The decode-against-forward check also
runs in bf16, to 3e-2 of the largest logit (the reason is at the test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import transformer as ref_T
from repro.parallel.sharding import ShardingCtx
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import ParamSpec, from_reference, tree_bytes, tree_map
from repro_torch.models.layers import rms_norm, rope, unembed

RTOL = 1e-4
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
DENSE = ["qwen3-8b", "qwen3-1.7b", "llama3-8b", "granite-3-8b"]
NEW = ["mamba2-1.3b", "mixtral-8x22b", "kimi-k2-1t-a32b"]  # the ssm and moe families
FAMILIES = ["jamba-v0.1-52b", "llama-3.2-vision-11b", "seamless-m4t-large-v2"]


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.max(np.abs(want)))
    assert float(np.max(np.abs(got - want))) <= rtol * scale, (
        float(np.max(np.abs(got - want))), scale)


def _pair(arch="qwen3-8b", **overrides):
    """(reference cfg, port cfg, reference params, port params)."""
    ref_cfg = ref_registry.get_smoke(arch, **overrides)
    cfg = registry.get_smoke(arch, **overrides)
    ref_params = ref_T.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = from_reference(jax.tree.map(np.asarray, ref_params), cfg)
    return ref_cfg, cfg, ref_params, params


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE + NEW + FAMILIES)
def test_configs_match_reference(arch):
    for get_ref, get in ((ref_registry.get_config, registry.get_config),
                         (ref_registry.get_smoke, registry.get_smoke)):
        want, got = get_ref(arch), get(arch)
        for f in dataclasses.fields(ModelConfig):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert (got.padded_vocab, got.param_count(), got.param_count(active_only=True)) == (
            want.padded_vocab, want.param_count(), want.param_count(active_only=True))
        if got.family == "ssm":
            assert (got.d_inner, got.ssm_heads) == (want.d_inner, want.ssm_heads)
        else:
            assert got.hd == want.hd
        assert [got.is_moe_layer(i) for i in range(got.n_layers)] == [
            want.is_moe_layer(i) for i in range(want.n_layers)]
        assert [got.is_attn_layer(i) for i in range(got.n_layers)] == [
            want.is_attn_layer(i) for i in range(want.n_layers)]
        assert got.dtype == torch.bfloat16 and got.pdtype == torch.bfloat16


def test_qwen3_8b_size():
    cfg = registry.get_config("qwen3-8b")
    assert cfg.padded_vocab == 152064
    assert 8.18e9 < cfg.param_count() < 8.20e9


def test_serving_sizes_of_the_new_families():
    """Mamba2-1.3B whole (1.344e9 parameters), Mixtral-8x22B at full width
    and 12 of its 56 layers (about 30.4e9 parameters, 61 GB in bf16), and
    their parameter trees as :func:`param_specs` lays them out."""
    mamba = registry.get_config("mamba2-1.3b")
    assert (mamba.d_inner, mamba.ssm_heads) == (4096, 64)
    assert 1.343e9 < mamba.param_count() < 1.345e9
    mixtral = registry.get_config("mixtral-8x22b", n_layers=12)
    assert mixtral.d_model == 6144 and mixtral.n_layers == 12
    assert 30.4e9 < mixtral.param_count() < 30.5e9
    shapes = tree_map(lambda s: s.shape, T.param_specs(mixtral))
    assert shapes["layers"]["ffn"]["wg"] == (12, 8, 6144, 16384)
    assert "mamba" in T.param_specs(mamba)["layers"]


def test_registry_lists_reference_archs_and_raises_for_later_slices():
    assert registry.list_archs() == ref_registry.list_archs()
    assert not hasattr(registry, "PENDING")  # every arch is built
    with pytest.raises(ValueError, match="unknown arch"):
        registry.get_config("gpt-2")


@pytest.mark.parametrize("arch", DENSE + NEW + FAMILIES)
def test_param_specs_match_reference(arch):
    cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
    ref_specs = jax.tree.map(lambda s: (s.shape, s.logical, s.init, s.scale),
                             ref_T.param_specs(ref_cfg),
                             is_leaf=lambda x: hasattr(x, "logical"))
    specs = tree_map(lambda s: (s.shape, s.logical, s.init, s.scale), T.param_specs(cfg))
    assert specs == ref_specs


def test_from_reference_carries_every_leaf():
    _, cfg, ref_params, params = _pair(**F32)
    flat = jax.tree.map(np.asarray, ref_params)
    tree_map(lambda got, want: np.testing.assert_array_equal(got.numpy(), want), params, flat)
    with pytest.raises(ValueError):
        from_reference(flat, dataclasses.replace(cfg, d_ff=cfg.d_ff * 2))


@pytest.mark.parametrize("arch", NEW)
def test_from_reference_carries_every_leaf_of_the_new_families(arch):
    _, cfg, ref_params, params = _pair(arch, **F32)
    flat = jax.tree.map(np.asarray, ref_params)
    tree_map(lambda got, want: np.testing.assert_array_equal(got.numpy(), want), params, flat)
    with pytest.raises(ValueError):
        from_reference(flat, dataclasses.replace(cfg, d_model=cfg.d_model * 2))


def test_from_reference_bf16_is_exact():
    _, _, ref_params, params = _pair()
    want = np.asarray(ref_params["layers"]["ffn"]["wg"]).astype(np.float32)
    assert params["layers"]["ffn"]["wg"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["layers"]["ffn"]["wg"].float().numpy(), want)


def test_init_params_seeded():
    cfg = registry.get_smoke("qwen3-8b")
    a = T.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = T.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    tree_map(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0), a, b)
    spec = T.param_specs(cfg)
    tree_map(lambda s, t: (tuple(t.shape), t.dtype) == (s.shape, s.dtype) or pytest.fail(),
             spec, a)
    assert float(a["layers"]["ln1"].min()) == 1.0  # "ones" init
    assert isinstance(spec["embed"]["final_norm"], ParamSpec)


def test_init_zeros_and_slice_by_slice(monkeypatch):
    """``"zeros"`` leaves (``A_log``, ``dt_bias``) are zero; a leaf larger
    than ``DRAW_ELEMENTS`` is drawn in runs of that many elements in its
    memory order (here its 12 (8, 8) slices), each run its own float32
    draw, scaled by the fan-in std."""
    from repro_torch.models import init

    cfg = registry.get_smoke("mamba2-1.3b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert float(params["layers"]["mamba"]["A_log"].abs().max()) == 0.0
    assert float(params["layers"]["mamba"]["dt_bias"].abs().max()) == 0.0
    assert float(params["layers"]["mamba"]["D"].min()) == 1.0
    monkeypatch.setattr(init, "DRAW_ELEMENTS", 64)
    spec = ParamSpec((3, 4, 8, 8), ("layers", None, None, None), dtype=torch.float32)
    leaf = init.materialize({"w": spec}, torch.Generator().manual_seed(5), "cpu")["w"]
    gen = torch.Generator().manual_seed(5)
    std = 1 / (4 * 8) ** 0.5  # fan-in of a stacked leaf leaves out "layers"
    for idx in np.ndindex(3, 4):  # 12 draws of (8, 8)
        want = torch.randn((8, 8), generator=gen, dtype=torch.float32) * std
        torch.testing.assert_close(leaf[idx], want, rtol=0, atol=0)


def test_layers_match_reference():
    from repro.models import layers as ref_layers

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.broadcast_to(np.arange(5) + 3, (2, 5))
    _close(rms_norm(torch.tensor(x), torch.tensor(scale), 1e-5).numpy(),
           ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5), 1e-6)
    _close(rope(torch.tensor(x), torch.tensor(pos), 1e6).numpy(),
           ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-5)


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen3-1.7b", "llama3-8b", *NEW])
def test_prefill_and_decode_match_reference(arch):
    """The slice as a whole: prefill logits and cache, then three decode
    steps, against the reference in float32.  A Mamba prompt is a whole
    number of its SMOKE chunks (8), as the reference's scan requires."""
    _prefill_and_decode_match(arch)


def test_kimi_k2_head_dim_112_matches_reference():
    """Kimi-K2's head dim (7168 / 64 = 112) on its SMOKE config narrowed to
    d_model 224 over 2 query heads and 1 KV head: prefill and decode
    against the reference, the prefill's attention through the forward
    kernel's plain version at D = 112."""
    narrow = dict(d_model=224, n_heads=2, n_kv_heads=1)
    assert registry.get_smoke("kimi-k2-1t-a32b", **narrow).hd == 112
    assert ref_registry.get_smoke("kimi-k2-1t-a32b", **narrow).hd == 112
    _prefill_and_decode_match("kimi-k2-1t-a32b", s=20, **narrow)


def _prefill_and_decode_match(arch, s=None, **overrides):
    ref_cfg, cfg, ref_params, params = _pair(arch, **F32, **overrides)
    ctx = ShardingCtx.none()
    b, max_len = 2, 20 if s is None else s + 8
    s = s or (16 if cfg.family == "ssm" else 12)
    prompt = _tokens(cfg, b, s)
    want_logits, want_cache = ref_T.prefill(ref_params, {"tokens": jnp.asarray(prompt)},
                                            ref_cfg, ctx, max_len)
    plan = serve.ServePlan(cfg=cfg, max_len=max_len, device=torch.device("cpu"))
    logits, cache = serve.make_prefill_fn(plan)(params, {"tokens": torch.tensor(prompt)})
    assert logits.shape == (b, s, cfg.padded_vocab) and logits.dtype == torch.float32
    _close(logits.numpy(), want_logits)

    def same_cache(got, want):
        assert sorted(got["layers"]) == sorted(want["layers"])
        for name, t in got["layers"].items():
            assert t.shape == want["layers"][name].shape, name
            _close(t.numpy(), want["layers"][name])

    same_cache(cache, want_cache)
    decode = serve.make_decode_fn(plan)
    steps = _tokens(cfg, b, 3, seed=1)
    for i in range(3):
        want, want_cache = ref_T.decode_step(ref_params, jnp.asarray(steps[:, i : i + 1]),
                                             want_cache, jnp.int32(s + i), ref_cfg, ctx)
        got, cache = decode(params, torch.tensor(steps[:, i : i + 1]), cache, s + i)
        assert got.shape == (b, 1, cfg.padded_vocab)
        _close(got.numpy(), want)
    same_cache(cache, want_cache)


@pytest.mark.parametrize("arch", NEW)
def test_forward_aux_loss_matches_reference(arch):
    """The MoE load-balancing loss that ``forward`` sums over the layers
    (0 for the ssm family), against the reference's."""
    ref_cfg, cfg, ref_params, params = _pair(arch, **F32)
    tokens = _tokens(cfg, 2, 16, seed=3)
    _, want, _ = ref_T.forward(ref_params, {"tokens": jnp.asarray(tokens)}, ref_cfg,
                               ShardingCtx.none())
    _, got, _ = T.forward(params, {"tokens": torch.tensor(tokens)}, cfg, mode="train")
    assert abs(float(got) - float(want)) <= 1e-6 * max(abs(float(want)), 1.0)
    assert (float(got) > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("dtype,tol", [("float32", RTOL), ("bfloat16", 3e-2)])
def test_decode_matches_forward(dtype, tol):
    """Token-by-token decode from an empty cache equals the full forward,
    as in ``test_arch_smoke.py``'s decode check; ``tol`` is relative to
    the largest logit.  In bf16 the forward's attention (the flash plain
    version) rounds P to bf16 before the normalisation and the decode's
    (the oracle) after it, as the reference's kernel and oracle do, so
    the two paths round at different places: a few bf16 ulps of the
    logits (1.4% of the largest at this seed)."""
    cfg = registry.get_smoke("qwen3-8b", param_dtype=dtype, compute_dtype=dtype)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b, s = 2, 8
    tokens = torch.tensor(_tokens(cfg, b, s))
    x, _, _ = T.forward(params, {"tokens": tokens}, cfg, mode="train")
    full = unembed(params["embed"], x, cfg)
    cache = T.init_cache(cfg, b, s, "cpu")
    for t in range(s):
        lg, cache = T.decode_step(params, tokens[:, t : t + 1], cache, t, cfg)
        _close(lg[:, 0].float().numpy(), full[:, t].float().numpy(), tol)


@pytest.mark.parametrize("arch,dtype,tol", [
    ("mamba2-1.3b", "float32", RTOL), ("mamba2-1.3b", "bfloat16", 3e-2),
    ("mixtral-8x22b", "float32", RTOL), ("mixtral-8x22b", "bfloat16", 3e-2),
])
def test_decode_matches_forward_new_families(arch, dtype, tol):
    """As :func:`test_decode_matches_forward` for the ssm and moe SMOKE
    configs: token-by-token decode from an empty cache equals the full
    forward.  Mamba: the forward's chunked scan and the decode's
    recurrence sum the state in another order and round y to bf16 at
    different steps; Mixtral's SMOKE capacity drops no token in either."""
    cfg = registry.get_smoke(arch, param_dtype=dtype, compute_dtype=dtype)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b, s = 2, 8
    tokens = torch.tensor(_tokens(cfg, b, s))
    x, _, _ = T.forward(params, {"tokens": tokens}, cfg, mode="train")
    full = unembed(params["embed"], x, cfg)
    cache = T.init_cache(cfg, b, s, "cpu")
    for t in range(s):
        lg, cache = T.decode_step(params, tokens[:, t : t + 1], cache, t, cfg)
        _close(lg[:, 0].float().numpy(), full[:, t].float().numpy(), tol)


def test_sliding_window_ring_cache_matches_reference():
    """A sliding-window config: the prefill's ring-layout cache and the
    ring-buffer decode agree with the reference."""
    ref_cfg, cfg, ref_params, params = _pair(sliding_window=8, **F32)
    ctx = ShardingCtx.none()
    prompt = _tokens(cfg, 2, 11, seed=4)
    want_logits, want_cache = ref_T.prefill(ref_params, {"tokens": jnp.asarray(prompt)},
                                            ref_cfg, ctx, 16)
    logits, cache = T.prefill(params, {"tokens": torch.tensor(prompt)}, cfg, 16)
    _close(logits.numpy(), want_logits)
    _close(cache["layers"]["v"].numpy(), want_cache["layers"]["v"])
    tok = _tokens(cfg, 2, 1, seed=5)
    want, _ = ref_T.decode_step(ref_params, jnp.asarray(tok), want_cache, jnp.int32(11),
                                ref_cfg, ctx)
    got, _ = T.decode_step(params, torch.tensor(tok), cache, 11, cfg)
    _close(got.numpy(), want)


def test_moe_sliding_window_ring_matches_reference():
    """Mixtral's SMOKE window (32) with a longer prompt: the ring-layout
    cache and the ring-buffer decode of the moe family agree with the
    reference."""
    ref_cfg, cfg, ref_params, params = _pair("mixtral-8x22b", **F32)
    ctx = ShardingCtx.none()
    prompt = _tokens(cfg, 2, 40, seed=6)
    want_logits, want_cache = ref_T.prefill(ref_params, {"tokens": jnp.asarray(prompt)},
                                            ref_cfg, ctx, 48)
    logits, cache = T.prefill(params, {"tokens": torch.tensor(prompt)}, cfg, 48)
    assert cache["layers"]["k"].shape[2] == cfg.sliding_window
    _close(logits.numpy(), want_logits)
    _close(cache["layers"]["k"].numpy(), want_cache["layers"]["k"])
    tok = _tokens(cfg, 2, 1, seed=7)
    want, _ = ref_T.decode_step(ref_params, jnp.asarray(tok), want_cache, jnp.int32(40),
                                ref_cfg, ctx)
    got, _ = T.decode_step(params, torch.tensor(tok), cache, 40, cfg)
    _close(got.numpy(), want)


def test_generate_first_decode_equals_longer_prefill():
    """Greedy generation on the CPU; the first decode step's logits equal
    the last logits of a prefill of the prompt plus the first new token."""
    cfg = registry.get_smoke("qwen3-8b", **F32)
    params = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    prompts = torch.tensor(_tokens(cfg, 3, 10, seed=2))
    plan = serve.ServePlan(cfg=cfg, max_len=15, device=torch.device("cpu"))
    res = serve.generate(plan, params, prompts, gen_len=5)
    assert res.tokens.shape == (3, 5) and len(res.decode_s) == 4
    assert int(res.tokens.max()) < cfg.vocab_size
    assert res.cache_bytes == 2 * cfg.n_layers * 3 * 15 * cfg.n_kv_heads * cfg.hd * 4
    longer = torch.cat([prompts, res.tokens[:, :1]], dim=1)
    want, _ = T.prefill(params, {"tokens": longer}, cfg, 16)
    _close(res.first_decode_logits.numpy(), want[:, -1].numpy())
    with pytest.raises(ValueError, match="max_len"):
        serve.generate(plan, params, prompts, gen_len=6)


def test_serve_cli_on_cpu(capsys):
    FK.launches["flash_fwd"] = 0
    assert serve.main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                       "--gen-len", "3"]) == 0
    out = capsys.readouterr().out
    assert "model qwen3-8b-smoke on cpu: batch=2 prompt=8 new=3" in out
    assert "over 2 steps" in out and "req1:" in out
    assert FK.launches["flash_fwd"] == 0  # the CPU runs the plain version


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "mixtral-8x22b"])
def test_generate_new_families(arch):
    """Greedy generation with the ssm and moe SMOKE configs on the CPU:
    the Mamba cache does not grow with the sequence, and the first decode
    step equals a prefill of the prompt plus the first new token.  The
    prompt (7 tokens) and the longer one (8) are each one whole Mamba
    chunk, as the scan requires (the SMOKE chunk is 8)."""
    cfg = registry.get_smoke(arch, **F32)
    params = T.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    prompts = torch.tensor(_tokens(cfg, 3, 7, seed=2))
    plan = serve.ServePlan(cfg=cfg, max_len=12, device=torch.device("cpu"))
    res = serve.generate(plan, params, prompts, gen_len=5)
    assert res.tokens.shape == (3, 5) and int(res.tokens.max()) < cfg.vocab_size
    if cfg.family == "ssm":
        per_layer = 3 * ((cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state)
                         + cfg.ssm_heads * cfg.ssm_state * cfg.ssm_headdim)
        assert res.cache_bytes == cfg.n_layers * per_layer * 4
    longer = torch.cat([prompts, res.tokens[:, :1]], dim=1)
    want, _ = T.prefill(params, {"tokens": longer}, cfg, 12)
    _close(res.first_decode_logits.numpy(), want[:, -1].numpy())


@pytest.mark.parametrize("arch", [*NEW, *FAMILIES])
def test_serve_cli_new_families_on_cpu(arch, capsys):
    from repro_torch.kernels.moe_gemm import kernel as MK
    from repro_torch.kernels.ssd_scan import kernel as SK

    SK.launches["ssd_fwd"] = MK.launches["moe_ffn_fwd"] = 0
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "16", "--gen-len", "3"]) == 0
    out = capsys.readouterr().out
    assert f"model {registry.get_smoke(arch).name} on cpu: batch=2 prompt=16 new=3" in out
    assert "over 2 steps" in out
    assert SK.launches["ssd_fwd"] == MK.launches["moe_ffn_fwd"] == 0  # plain versions


def test_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke"])


def test_serve_cli_jamba_needs_layers(capsys):
    """Jamba's 52 B parameters do not fit one card: the CLI says so before
    it makes any weight, and ``--layers`` cuts the depth."""
    with pytest.raises(SystemExit):
        serve.main(["--arch", "jamba-v0.1-52b", "--device", "cpu"])
    assert "--layers" in capsys.readouterr().err
    assert serve.main(["--arch", "jamba-v0.1-52b", "--smoke", "--layers", "4", "--device",
                       "cpu", "--batch", "1", "--prompt-len", "8", "--gen-len", "2"]) == 0
    assert "model jamba-smoke on cpu" in capsys.readouterr().out


def test_other_families_raise():
    cfg = registry.get_smoke("qwen3-8b")
    with pytest.raises(ValueError, match="unknown family 'rnn'"):
        dataclasses.replace(cfg, family="rnn")
    assert tree_bytes(T.init_cache(cfg, 1, 4, "cpu")) == 2 * 4 * 4 * 2 * cfg.hd * 2
