"""Port parity of the attention kernels' plain versions and the oracles.

The same inputs, made with NumPy from a seed, go through the JAX
package's Pallas ``flash_fwd`` in interpret mode and through the port's
``flash_fwd_torch``, which is what a CPU tensor runs.  The first cases
run the reference at 64 x 64 tiles against the port's forward tiles
(128 x 128; the rows that see no key are the same under both); the
cases at the end give the reference the port's forward tiles, so that
block skipping and the NEG_INF conventions line up on any shape.  float32: O and
LSE agree to 1e-5 (sums in another order).  bfloat16: P and O are
rounded to bf16 at the same places on both sides, so O agrees to one
bf16 ulp at |O| <= 1 (2**-7 absolute, a rounding that lands on the
other side of a tie-break after float32 sums in another order) and LSE,
kept in float32, to 1e-5.  The CUDA kernel is held against the plain
version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as ref_kernel
from repro.kernels.flash_attention import ref as ref_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref

RTOL = 1e-5
#: The reference forward's tiles in the first cases: other than the port's.
REF_BLOCK = 64


def _qkv(b, hq, hkv, sq, skv, d, seed, layout="bhsd"):
    rng = np.random.default_rng(seed)
    if layout == "bhsd":
        shapes = [(b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)]
    else:
        shapes = [(b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _reference(q, k, v, causal, window, dtype=jnp.float32):
    o, lse = ref_kernel.flash_fwd(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        scale=q.shape[-1] ** -0.5, causal=causal, window=window,
        block_q=REF_BLOCK, block_k=REF_BLOCK, interpret=True,
    )
    return np.asarray(o.astype(jnp.float32)), np.asarray(lse)


def _port(q, k, v, causal, window, dtype=torch.float32):
    o, lse = K.flash_fwd(*(torch.tensor(a).to(dtype) for a in (q, k, v)),
                         scale=q.shape[-1] ** -0.5, causal=causal, window=window)
    assert o.dtype == dtype and lse.dtype == torch.float32
    return o.float().numpy(), lse.numpy()


CASES = [
    # hq, hkv, sq, skv, causal, window
    pytest.param(4, 4, 128, 128, True, None, id="causal-g1"),
    pytest.param(4, 2, 128, 128, True, None, id="causal-g2"),
    pytest.param(8, 2, 128, 128, True, None, id="causal-g4"),
    pytest.param(4, 2, 192, 192, True, 40, id="causal-window-g2"),
    pytest.param(4, 1, 64, 192, False, None, id="noncausal-sq<skv-g4"),
    pytest.param(4, 2, 192, 64, False, None, id="noncausal-sq>skv-g2"),
    pytest.param(4, 4, 128, 128, False, 48, id="window-only-g1"),
    # rows i >= 96 see no key: the NEG_INF / 1e-30 conventions decide them
    pytest.param(2, 1, 192, 64, False, 32, id="rows-without-keys"),
]


@pytest.mark.parametrize("hq,hkv,sq,skv,causal,window", CASES)
def test_plain_matches_reference_kernel_f32(hq, hkv, sq, skv, causal, window):
    q, k, v = _qkv(1, hq, hkv, sq, skv, 16, seed=hq * sq + skv)
    got, want = _port(q, k, v, causal, window), _reference(q, k, v, causal, window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("hq,hkv,sq,skv,causal,window", CASES[1:4])
def test_plain_matches_reference_kernel_bf16(hq, hkv, sq, skv, causal, window):
    q, k, v = _qkv(1, hq, hkv, sq, skv, 32, seed=sq)
    (o, lse), (o_ref, lse_ref) = (_port(q, k, v, causal, window, torch.bfloat16),
                                  _reference(q, k, v, causal, window, jnp.bfloat16))
    np.testing.assert_allclose(o, o_ref, rtol=0, atol=2.0**-7)
    np.testing.assert_allclose(lse, lse_ref, rtol=RTOL, atol=RTOL)


def test_ragged_lengths_match_dense_attention():
    """Lengths that are not a multiple of the tiles (the kernel masks the
    tail keys with -inf): the plain version equals dense softmax."""
    q, k, v = _qkv(2, 4, 2, 100, 100, 16, seed=5, layout="bshd")
    for causal, window in ((True, None), (True, 30), (False, None)):
        got = flash_attention(*(torch.tensor(a) for a in (q, k, v)), causal=causal,
                              window=window)
        want = ref.ref_attention(*(torch.tensor(a) for a in (q, k, v)), causal=causal,
                                 window=window)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24), (False, None)])
def test_op_matches_reference_oracle(causal, window):
    """(B, S, H, D) at the public face, against the reference's oracle."""
    q, k, v = _qkv(2, 8, 2, 128, 128, 16, seed=9, layout="bshd")
    got = flash_attention(*(torch.tensor(a) for a in (q, k, v)), causal=causal, window=window)
    want = ref_ref.ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal, window=window)
    assert got.shape == (2, 128, 8, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("kwargs", [
    {"causal": True},
    {"causal": True, "window": 5},
    {"causal": False, "kv_len": 9},
    {"causal": False, "kv_len": 0},  # every row masked: the guard gives 0
    {"causal": True, "q_offset": 7, "kv_len": 12},
])
def test_oracle_matches_reference(kwargs):
    q, k, v = _qkv(2, 4, 2, 5, 12, 8, seed=3, layout="bshd")
    got = ref.ref_attention(*(torch.tensor(a) for a in (q, k, v)), **kwargs)
    want = ref_ref.ref_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kwargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("bad,exc", [
    (lambda q, k, v: (q[0], k, v), ValueError),  # 3-d q
    (lambda q, k, v: (q, k[:, :, :5], v), ValueError),  # k, v lengths differ
    (lambda q, k, v: (q[:, :3], k, v), ValueError),  # Hq not a multiple of Hkv
    (lambda q, k, v: (q, k.double(), v), TypeError),  # mixed dtypes
    (lambda q, k, v: (q, k.to("meta"), v), ValueError),  # mixed devices
])
def test_wrapper_rejects_bad_inputs(bad, exc):
    q, k, v = (torch.tensor(a) for a in _qkv(1, 4, 2, 8, 8, 8, seed=0))
    with pytest.raises(exc):
        K.flash_fwd(*bad(q, k, v), scale=1.0, causal=True, window=None)


def test_wrapper_never_falls_back_off_the_cpu():
    q, k, v = (torch.tensor(a).to("meta") for a in _qkv(1, 4, 2, 8, 8, 8, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        K.flash_fwd(q, k, v, scale=1.0, causal=True, window=None)
    assert K.launches == {"flash_fwd": 0, "flash_dkv": 0, "flash_dq": 0}


# ---------------------------------------------------------------------------
# Backward: flash_dkv / flash_dq and the autograd Function
# ---------------------------------------------------------------------------
#
# float32.  Each plain version walks its kernel's own blocks (flash_dkv
# DKV_BLOCK_Q x DKV_BLOCK_K = 64 x 128, flash_dq DQ_BLOCK_Q x DQ_BLOCK_K =
# 128 x 64), and the reference's Pallas kernel of the same name takes the
# same blocks in interpret mode; the reference forward's LSE and delta =
# rowsum(dO * O) feed both.  dQ, dK and dV agree to 1e-5 of their largest
# magnitude (float32 sums in another order).  The Function's gradients
# against jax.grad of the reference's op in interpret mode (its custom
# VJP, the Pallas dkv/dq kernels), to 1e-4 (the two forwards and the loss
# add their float32 roundings).

BWD_CASES = [
    # hq, hkv, s, causal, window
    pytest.param(4, 4, 128, True, None, id="causal-g1"),
    pytest.param(4, 2, 128, True, None, id="causal-g2"),
    pytest.param(8, 2, 128, True, None, id="causal-g4"),
    pytest.param(4, 2, 128, True, 40, id="causal-window-g2"),
    pytest.param(6, 2, 128, False, None, id="noncausal-g3"),
    pytest.param(4, 1, 128, False, 48, id="window-only-g4"),
]


def _close_scaled(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want)))
    assert float(np.max(np.abs(got - want))) <= rtol * scale, (
        float(np.max(np.abs(got - want))), scale)


def _reference_backward(q, k, v, do, kw):
    """(LSE, delta, dK, dV, dQ) of the reference's Pallas kernels in
    interpret mode, each backward kernel at its port counterpart's blocks."""
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    o, lse = ref_kernel.flash_fwd(jq, jk, jv, block_q=K.FWD_BLOCK_Q, block_k=K.FWD_BLOCK_K,
                                  interpret=True, **kw)
    delta = jnp.sum(jdo * o, axis=-1)
    dk, dv = ref_kernel.flash_dkv(jq, jk, jv, jdo, lse, delta, block_q=K.DKV_BLOCK_Q,
                                  block_k=K.DKV_BLOCK_K, interpret=True, **kw)
    dq = ref_kernel.flash_dq(jq, jk, jv, jdo, lse, delta, block_q=K.DQ_BLOCK_Q,
                             block_k=K.DQ_BLOCK_K, interpret=True, **kw)
    return (np.asarray(x) for x in (lse, delta, dk, dv, dq))


def _port_backward(q, k, v, do, lse, delta, kw):
    args = [torch.tensor(a) for a in (q, k, v, do, lse, delta)]
    dk, dv = K.flash_dkv(*args, **kw)
    dq = K.flash_dq(*args, **kw)
    assert dk.dtype == dv.dtype == dq.dtype == torch.float32
    return dk.numpy(), dv.numpy(), dq.numpy()


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("hq,hkv,s,causal,window", BWD_CASES)
def test_backward_plain_matches_reference_kernels(hq, hkv, s, causal, window, d):
    extra = 0 if d == 16 else d  # the head dim 16 cases keep their first inputs
    q, k, v = _qkv(2 if d == 16 else 1, hq, hkv, s, s, d, seed=hq * s + hkv + extra)
    do = np.random.default_rng(s + extra).standard_normal(q.shape).astype(np.float32)
    kw = dict(scale=d ** -0.5, causal=causal, window=window)
    lse, delta, *want = _reference_backward(q, k, v, do, kw)
    got = _port_backward(q, k, v, do, lse, delta, kw)
    for g, w in zip(got, want):
        _close_scaled(g, w, RTOL)


@pytest.mark.parametrize("hq,hkv,s,causal,window", BWD_CASES[1:4])
def test_attention_gradients_match_reference_op(hq, hkv, s, causal, window):
    """The Function (forward kernel, dkv and dq kernels: their plain
    versions here) against jax.grad through the reference's Pallas op."""
    from repro.kernels.flash_attention.ops import flash_attention as ref_flash_attention

    q, k, v = _qkv(2, hq, hkv, s, s, 16, seed=7, layout="bshd")
    w = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)

    def loss_ref(q, k, v):
        o = ref_flash_attention(q, k, v, causal=causal, window=window, impl="interpret",
                                block_q=K.FWD_BLOCK_Q, block_k=K.FWD_BLOCK_K)
        return jnp.sum(o * w)

    want = jax.grad(loss_ref, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    (flash_attention(*ts, causal=causal, window=window) * torch.tensor(w)).sum().backward()
    for t, g in zip(ts, want):
        assert t.grad.dtype == torch.float32 and t.grad.shape == t.shape
        _close_scaled(t.grad.numpy(), g, 1e-4)


def test_attention_gradients_keep_the_input_type():
    """bf16 inputs get bf16 gradients in the (B, S, H, D) layout, within
    bf16 rounding (2e-2 of the largest) of the float32 ones."""
    q, k, v = _qkv(1, 4, 2, 128, 128, 32, seed=11, layout="bshd")
    grads = {}
    for dtype in (torch.float32, torch.bfloat16):
        ts = [torch.tensor(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
        flash_attention(*ts).float().square().sum().backward()
        grads[dtype] = [t.grad for t in ts]
    for lo, hi in zip(grads[torch.bfloat16], grads[torch.float32]):
        assert lo.dtype == torch.bfloat16 and lo.shape == hi.shape
        _close_scaled(lo.float().numpy(), hi.numpy(), 2e-2)


def test_backward_wrappers_never_fall_back_off_the_cpu():
    q, k, v = (torch.tensor(a).to("meta") for a in _qkv(1, 4, 2, 8, 8, 8, seed=0))
    rows = torch.zeros((1, 4, 8), device="meta")
    for fn in (K.flash_dkv, K.flash_dq):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, v, q, rows, rows, scale=1.0, causal=True, window=None)
    q, k, v = (torch.tensor(a) for a in _qkv(1, 4, 2, 8, 8, 8, seed=0))
    with pytest.raises(ValueError, match="float32"):  # a row of LSE missing
        K.flash_dq(q, k, v, q, torch.zeros(1, 4, 7), torch.zeros(1, 4, 8), scale=1.0,
                   causal=True, window=None)
    assert K.launches == {"flash_fwd": 0, "flash_dkv": 0, "flash_dq": 0}


# ---------------------------------------------------------------------------
# The forward kernel's own tiles, and head dim 112 (Kimi-K2: 7168 / 64)
# ---------------------------------------------------------------------------
#
# The forward kernel walks FWD_BLOCK_Q x FWD_BLOCK_K = 128 x 128 tiles, so
# its plain version does too; here the reference's Pallas kernels take the
# same blocks (lengths that 128 divides), so block skipping and the rows
# that see no key line up exactly.

FWD_CASES = [
    # hq, hkv, sq, skv, causal, window
    pytest.param(4, 2, 256, 256, True, None, id="causal-g2"),
    pytest.param(6, 1, 256, 256, True, 100, id="causal-window-g6"),
    pytest.param(4, 4, 128, 384, False, None, id="noncausal-sq<skv-g1"),
    # rows i >= 159 see no key: the NEG_INF / 1e-30 conventions decide them
    pytest.param(2, 1, 384, 128, False, 32, id="rows-without-keys"),
]


def _reference_fwd_blocks(q, k, v, causal, window, dtype=jnp.float32):
    o, lse = ref_kernel.flash_fwd(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        scale=q.shape[-1] ** -0.5, causal=causal, window=window,
        block_q=K.FWD_BLOCK_Q, block_k=K.FWD_BLOCK_K, interpret=True,
    )
    return np.asarray(o.astype(jnp.float32)), np.asarray(lse)


@pytest.mark.parametrize("d", [16, 112])
@pytest.mark.parametrize("hq,hkv,sq,skv,causal,window", FWD_CASES)
def test_plain_matches_reference_kernel_at_forward_blocks(hq, hkv, sq, skv, causal, window, d):
    q, k, v = _qkv(1, hq, hkv, sq, skv, d, seed=hq * sq + skv + d)
    got = _port(q, k, v, causal, window)
    want = _reference_fwd_blocks(q, k, v, causal, window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("hq,hkv,sq,skv,causal,window", FWD_CASES[:2])
def test_plain_matches_reference_kernel_at_forward_blocks_bf16_d112(hq, hkv, sq, skv, causal,
                                                                   window):
    q, k, v = _qkv(1, hq, hkv, sq, skv, 112, seed=sq + hq)
    (o, lse), (o_ref, lse_ref) = (_port(q, k, v, causal, window, torch.bfloat16),
                                  _reference_fwd_blocks(q, k, v, causal, window, jnp.bfloat16))
    np.testing.assert_allclose(o, o_ref, rtol=0, atol=2.0**-7)
    np.testing.assert_allclose(lse, lse_ref, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("hq,hkv,s,causal,window", [
    pytest.param(4, 2, 128, True, None, id="causal-g2"),
    pytest.param(4, 1, 256, True, 40, id="causal-window-g4"),
    pytest.param(6, 6, 128, False, None, id="noncausal-g1"),
])
def test_backward_plain_matches_reference_kernels_d112(hq, hkv, s, causal, window):
    """flash_dkv_torch and flash_dq_torch at D = 112 against the Pallas
    kernels in interpret mode, each at its kernel's blocks, with the
    reference forward's LSE and delta."""
    q, k, v = _qkv(1, hq, hkv, s, s, 112, seed=s + hq)
    do = np.random.default_rng(hq).standard_normal(q.shape).astype(np.float32)
    kw = dict(scale=112 ** -0.5, causal=causal, window=window)
    lse, delta, *want = _reference_backward(q, k, v, do, kw)
    got = _port_backward(q, k, v, do, lse, delta, kw)
    for g, w in zip(got, want):
        _close_scaled(g, w, RTOL)


@pytest.mark.parametrize("hq,hkv,s,window,d", [
    pytest.param(6, 1, 200, None, 64, id="s200-g6-d64"),
    pytest.param(4, 2, 200, 64, 112, id="s200-window-g2-d112"),
    pytest.param(8, 2, 100, None, 128, id="s100-g4-d128"),
])
def test_backward_plain_matches_reference_kernels_ragged(hq, hkv, s, window, d):
    """Causal lengths that no block divides: the plain versions on S rows
    against the Pallas kernels on the inputs zero-padded to a multiple of
    128.  The padded keys lie after every real query, so they are masked
    for it; the padded queries have dO = 0 and delta = 0, so they add
    exactly 0 to dK and dV; and no block that the padding adds changes
    which blocks the real rows see."""
    n = -(-s // 128) * 128
    q, k, v = _qkv(1, hq, hkv, n, n, d, seed=s + d)
    do = np.random.default_rng(d).standard_normal(q.shape).astype(np.float32)
    for a in (q, k, v, do):
        a[:, :, s:] = 0.0
    kw = dict(scale=d ** -0.5, causal=True, window=window)
    lse, delta, dk_want, dv_want, dq_want = _reference_backward(q, k, v, do, kw)
    got = _port_backward(*(a[:, :, :s] for a in (q, k, v, do, lse, delta)), kw)
    for g, w in zip(got, (dk_want, dv_want, dq_want)):
        _close_scaled(g, w[:, :, :s], RTOL)


@pytest.mark.parametrize("d", [64, 112])
def test_backward_plain_matches_reference_kernels_rows_without_keys(d):
    """Non-causal, window 32, Sq = 384 against Skv = 128: rows 159 and
    later see no key, so their LSE is NEG_INF and the masked pairs of the
    blocks each kernel does not skip get P = 1.  Which blocks those are
    depends on each kernel's own blocks, which the plain versions walk."""
    q, k, v = _qkv(1, 2, 1, 384, 128, d, seed=d)
    do = np.random.default_rng(d + 1).standard_normal(q.shape).astype(np.float32)
    kw = dict(scale=d ** -0.5, causal=False, window=32)
    lse, delta, *want = _reference_backward(q, k, v, do, kw)
    assert float(lse[0, 0, -1]) <= K.NEG_INF / 2
    got = _port_backward(q, k, v, do, lse, delta, kw)
    for g, w in zip(got, want):
        _close_scaled(g, w, RTOL)


def test_kernel_head_dims():
    """The CUDA wrappers take bf16 at head dims 16, 32, 64, 112 and 128 and
    refuse any other (checked before a launch, so on CPU tensors too)."""
    assert K.KERNEL_HEAD_DIMS == (16, 32, 64, 112, 128)
    for d in K.KERNEL_HEAD_DIMS:
        q = torch.zeros((1, 2, 8, d), dtype=torch.bfloat16)
        K._kernel_args("flash_fwd", {"q": q, "k": q, "v": q})
    for d in (8, 48, 96, 120, 256):
        q = torch.zeros((1, 2, 8, d), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim"):
            K._kernel_args("flash_dq", {"q": q, "k": q, "v": q})
    with pytest.raises(TypeError, match="bfloat16"):
        K._kernel_args("flash_fwd", {"q": torch.zeros((1, 2, 8, 112))})


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_every_config_head_dim_is_a_kernel_head_dim(smoke):
    """Every registered config, SMOKE included, attends through the kernels
    on the card: its head dim is one they are built for."""
    from repro_torch.configs import registry

    for arch in registry.list_archs():
        cfg = registry.get_smoke(arch) if smoke else registry.get_config(arch)
        if cfg.n_heads:
            assert cfg.hd in K.KERNEL_HEAD_DIMS, (arch, cfg.hd)
