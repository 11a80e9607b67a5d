"""Port parity of the mixture-of-experts FFN: the expert GEMM
(``repro_torch.kernels.moe_gemm``) and the router and dispatch of
``repro_torch.models.moe``.

The same NumPy inputs go through the JAX package and through the port on
the CPU, where the ``moe_ffn_fwd`` wrapper runs its plain version.  The
expert FFN against the reference's Pallas kernel in interpret mode:
float32 to 1e-5 of the largest output (sums in another order); bfloat16
to 2e-2 (both round the activation and the output to bf16 at the same
places, a rounding may land on the other side after float32 sums in
another order).  ``moe_apply`` in float32: the routing (top-k choices,
slot positions) and the set of dropped (token, choice) pairs are equal,
and the output agrees to 1e-5, both at a capacity factor that drops
pairs and at one that drops none.  The CUDA kernel is held against the
plain version on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm import ref as ref_ref
from repro.kernels.moe_gemm.ops import moe_ffn as ref_moe_ffn
from repro.models import moe as ref_moe
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.init import materialize
from repro.parallel.sharding import ShardingCtx
from repro_torch.kernels.moe_gemm import kernel as K
from repro_torch.kernels.moe_gemm import moe_ffn, ref
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import tree_map

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want)))
    assert float(np.max(np.abs(got - want))) <= rtol * scale, (
        float(np.max(np.abs(got - want))), scale)


def _ffn_inputs(e, c, dm, df, seed):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(shape)).astype(np.float32)
            for shape, scale in (((e, c, dm), 0.1), ((e, dm, df), 0.05), ((e, dm, df), 0.05),
                                 ((e, df, dm), 0.05))]


# (E, Cap, Dm, Dff): the reference's MOE_CASES and the ragged caps the model makes
FFN_CASES = [
    pytest.param(4, 256, 128, 512, id="e4-cap256"),
    pytest.param(8, 128, 64, 256, id="e8-cap128"),
    pytest.param(2, 512, 256, 128, id="e2-cap512"),
    pytest.param(16, 64, 128, 128, id="e16-cap64"),
    pytest.param(8, 8, 64, 128, id="e8-cap8"),
    pytest.param(4, 40, 64, 128, id="e4-cap40"),
]


@pytest.mark.parametrize("e,c,dm,df", FFN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_reference_kernel(e, c, dm, df, dtype):
    arrays = _ffn_inputs(e, c, dm, df, seed=e + c)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = ref_moe_ffn(*(jnp.asarray(a, jdt) for a in arrays), impl="interpret")
    K.launches["moe_ffn_fwd"] = 0
    got = moe_ffn(*(torch.tensor(a).to(getattr(torch, dtype)) for a in arrays))
    assert K.launches["moe_ffn_fwd"] == 0  # the CPU runs the plain version
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           RTOL if dtype == "float32" else 2e-2)


def test_moe_ffn_ref_matches_reference():
    arrays = _ffn_inputs(4, 32, 64, 96, seed=3)
    _close(ref.moe_ffn_ref(*(torch.tensor(a) for a in arrays)).numpy(),
           ref_ref.moe_ffn_ref(*(jnp.asarray(a) for a in arrays)))


def test_moe_ffn_checks_its_inputs():
    x, wg, wu, wd = (torch.tensor(a) for a in _ffn_inputs(2, 8, 16, 24, seed=4))
    with pytest.raises(ValueError, match="do not fit"):
        moe_ffn(x, wg, wu, wd[:, :8])
    with pytest.raises(TypeError, match="one dtype"):
        moe_ffn(x, wg.bfloat16(), wu, wd)


def _cfgs(cf: float, group: int = 1024):
    fields = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=1,
                  d_ff=64, vocab_size=64, n_experts=4, top_k=2, capacity_factor=cf,
                  moe_group=group, param_dtype="float32", compute_dtype="float32")
    return RefModelConfig(**fields, moe_impl="xla"), ModelConfig(**fields)


def _params(ref_cfg, cfg, seed=0):
    """The reference's MoE parameters, and the same numbers as the port's."""
    ref_params = jax.tree.map(np.asarray, materialize(ref_moe.moe_specs(ref_cfg),
                                                      jax.random.PRNGKey(seed)))
    params = tree_map(lambda spec, a: torch.tensor(a).to(spec.dtype), moe.moe_specs(cfg),
                      ref_params)
    return ref_params, params


@pytest.mark.parametrize("cf,group,tokens", [
    pytest.param(1.0, 1024, 64, id="drops-one-group"),
    pytest.param(1.0, 16, 64, id="drops-four-groups"),
    pytest.param(8.0, 1024, 24, id="no-drops"),
    pytest.param(1.25, 8, 36, id="ragged-count-one-group"),
])
def test_moe_apply_matches_reference(cf, group, tokens, monkeypatch):
    ref_cfg, cfg = _cfgs(cf, group)
    ref_params, params = _params(ref_cfg, cfg)
    x = (0.3 * np.random.default_rng(9).standard_normal((2, tokens // 2, 32))).astype(np.float32)
    xt = x.reshape(tokens, 32)
    # routing: choices, gates and aux
    choice, gates, aux = moe._route(params, torch.tensor(xt), cfg)
    r_choice, r_gates, r_aux = ref_moe._route(ref_params, jnp.asarray(xt), ref_cfg)
    np.testing.assert_array_equal(choice.numpy(), np.asarray(r_choice))
    _close(gates.numpy(), r_gates)
    _close(aux.numpy(), r_aux)
    # the dropped set, group by group
    g, cap = moe.capacity(cfg, tokens)
    cg = choice.reshape(tokens // g, g, -1)
    pos, keep = moe._slot_positions(cg, cfg.n_experts, cap)
    for i in range(tokens // g):
        r_pos, r_keep = ref_moe._slot_positions(jnp.asarray(cg[i].numpy()), cfg.n_experts, cap)
        np.testing.assert_array_equal(pos[i].numpy(), np.asarray(r_pos))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(r_keep))
    # moe_apply keeps exactly that set: its slot positions, seen as it runs
    seen = []
    slot_positions = moe._slot_positions

    def recording(*args):
        seen.append(slot_positions(*args))
        return seen[-1]

    monkeypatch.setattr(moe, "_slot_positions", recording)
    out, aux = moe.moe_apply(params, torch.tensor(x), cfg)
    r_out, r_aux = ref_moe.moe_apply(ref_params, jnp.asarray(x), ref_cfg, ShardingCtx.none())
    _close(out.numpy(), r_out)
    _close(aux.numpy(), r_aux)
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0][1].numpy(), keep.numpy())
    assert (int((~keep).sum()) > 0) == (cf == 1.0)


def test_capacity_as_the_reference():
    """Group size and capacity for the token counts serving makes: the
    Mixtral-8x22B prefill (4 x 2048: 8 groups of 1024, cap 320), its
    decode (4 tokens: cap 8) and a prompt of 4 x 2049 (one group)."""
    cfg = dataclasses.replace(_cfgs(1.25)[1], n_experts=8, top_k=2)
    assert moe.capacity(cfg, 4 * 2048) == (1024, 320)
    assert moe.capacity(cfg, 4) == (4, 8)
    assert moe.capacity(cfg, 4 * 2049) == (8196, 2568)
    no_drop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    for n in (4, 4 * 2049, 8192):
        g, cap = moe.capacity(no_drop, n)
        assert cap >= g  # every token fits its expert


# ---------------------------------------------------------------------------
# Backward: the autograd Function (kernel forward, oracle backward)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("e,c,dm,df", [pytest.param(4, 128, 64, 256, id="e4-cap128"),
                                       pytest.param(2, 256, 128, 128, id="e2-cap256")])
def test_moe_ffn_gradients_match_reference_op(e, c, dm, df):
    """float32: the Function's gradients against jax.grad through the
    reference's Pallas op in interpret mode (its custom VJP recomputes
    through the oracle, as the port's does), to 1e-5 of the largest."""
    arrays = _ffn_inputs(e, c, dm, df, seed=8)
    w = np.random.default_rng(9).standard_normal((e, c, dm)).astype(np.float32)

    def loss_ref(*a):
        return jnp.sum(ref_moe_ffn(*a, impl="interpret") * w)

    want = jax.grad(loss_ref, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    (moe_ffn(*ts) * torch.tensor(w)).sum().backward()
    for t, g in zip(ts, want):
        assert t.grad.shape == t.shape
        _close(t.grad.numpy(), g)


def test_moe_ffn_backward_recomputes_through_the_oracle():
    """bf16: the gradients are those of ``moe_ffn_ref`` (which rounds the
    gate and up products to bf16, ROADMAP R5), bit for bit, whatever the
    forward computed."""
    arrays = _ffn_inputs(2, 24, 32, 64, seed=10)
    ts = [torch.tensor(a).to(torch.bfloat16).requires_grad_(True) for a in arrays]
    moe_ffn(*ts).float().square().sum().backward()
    got = [t.grad for t in ts]
    ts2 = [t.detach().clone().requires_grad_(True) for t in ts]
    out = ref.moe_ffn_ref(*ts2)
    out.backward(2 * moe_ffn(*ts2).detach().float().to(out.dtype))
    for a, b in zip(got, (t.grad for t in ts2)):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b)
