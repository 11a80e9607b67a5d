"""Port parity of the Mamba-2 SSD scan (``repro_torch.kernels.ssd_scan``).

The same inputs, made with NumPy from a seed, go through the JAX
package's op (``ssd_scan(impl="interpret")``, its Pallas ``ssd_fwd`` in
interpret mode) or oracle and through the port's counterpart on the CPU,
where the ``ssd_fwd`` wrapper runs its plain version.  float32: y and
the final state agree to 1e-5 of their largest magnitude (float32 sums
in another order).  bfloat16 (x, B and C in bf16, as the model feeds
them): y is rounded to bf16 on both sides, so it agrees to 2e-2 of its
largest magnitude (a bf16 ulp is 2**-8 relative; a rounding may land on
the other side after float32 sums in another order), the float32 state
to 1e-5.  The CUDA kernel is held against the plain version on the card
by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import kernel as ref_kernel
from repro.kernels.ssd_scan import ref as ref_ref
from repro.kernels.ssd_scan.ops import ssd_scan as ref_ssd_scan
from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan import ref, ssd_scan

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want)))
    assert float(np.max(np.abs(got - want))) <= rtol * scale, (
        float(np.max(np.abs(got - want))), scale)


def _inputs(b, s, h, p, g, n, seed):
    """x, dt, A, Bm, Cm, D as the reference's ``_ssd_inputs``, in NumPy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    Bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    Cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    D = rng.standard_normal((h,)).astype(np.float32)
    return x, dt, A, Bm, Cm, D


def _as_jax(arrays, low=()):
    """JAX arrays; the ones named by index in ``low`` in bf16."""
    return [jnp.asarray(a, jnp.bfloat16 if i in low else jnp.float32)
            for i, a in enumerate(arrays)]


def _as_torch(arrays, low=()):
    return [torch.tensor(a).to(torch.bfloat16 if i in low else torch.float32)
            for i, a in enumerate(arrays)]


# (b, s, h, p, g, n, chunk): one and two groups, one and several chunks
CASES = [
    pytest.param(2, 64, 4, 16, 1, 8, 16, id="g1-4chunks"),
    pytest.param(2, 128, 4, 32, 2, 16, 32, id="g2-4chunks"),
    pytest.param(1, 96, 6, 24, 2, 16, 96, id="g2-1chunk"),
    pytest.param(1, 256, 8, 64, 2, 32, 64, id="g2-4chunks-wide"),
    pytest.param(2, 48, 2, 8, 1, 16, 64, id="g1-chunk-longer-than-seq"),
]
BF16 = (0, 3, 4)  # x, Bm, Cm


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_reference_kernel(b, s, h, p, g, n, chunk, dtype):
    """The op as a whole: transposes, dA, the kernel (interpret mode on
    the reference's side, the plain version on the port's) and the D * x
    skip added in the working type."""
    arrays = _inputs(b, s, h, p, g, n, seed=b * s + h)
    low = BF16 if dtype == "bfloat16" else ()
    want_y, want_st = ref_ssd_scan(*_as_jax(arrays, low), chunk=chunk, impl="interpret")
    y, st = ssd_scan(*_as_torch(arrays, low), chunk=chunk)
    assert y.dtype == getattr(torch, dtype) and st.dtype == torch.float32
    _close(y.float().numpy(), np.asarray(want_y.astype(jnp.float32)),
           RTOL if dtype == "float32" else 2e-2)
    _close(st.numpy(), want_st)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES[:3])
def test_ssd_fwd_plain_matches_pallas_kernel(b, s, h, p, g, n, chunk):
    """The kernel's own layout: (B, H, S, P) and dA given, no D * x."""
    x, dt, A, Bm, Cm, _ = _inputs(b, s, h, p, g, n, seed=7)
    xk, dtk = x.transpose(0, 2, 1, 3), dt.transpose(0, 2, 1)
    dak = dtk * A[None, :, None]
    Bk, Ck = Bm.transpose(0, 2, 1, 3), Cm.transpose(0, 2, 1, 3)
    want_y, want_st = ref_kernel.ssd_fwd(*(jnp.asarray(a) for a in (xk, dtk, dak, Bk, Ck)),
                                         chunk=chunk, interpret=True)
    K.launches["ssd_fwd"] = 0
    y, st = K.ssd_fwd(*(torch.tensor(np.ascontiguousarray(a)) for a in (xk, dtk, dak, Bk, Ck)),
                      chunk=chunk)
    assert K.launches["ssd_fwd"] == 0  # the CPU runs the plain version
    _close(y.numpy(), want_y)
    _close(st.numpy(), want_st)


@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "init-state"])
def test_oracles_match_reference(with_state):
    x, dt, A, Bm, Cm, D = _inputs(2, 64, 4, 16, 2, 8, seed=11)
    init = (np.random.default_rng(12).standard_normal((2, 4, 8, 16)).astype(np.float32)
            if with_state else None)
    args = (x, dt, A, Bm, Cm, D)
    j_args = [jnp.asarray(a) for a in args]
    t_args = [torch.tensor(a) for a in args]
    j_init = None if init is None else jnp.asarray(init)
    t_init = None if init is None else torch.tensor(init)
    for got, want in (
        (ref.ssd_quadratic(*t_args, t_init), ref_ref.ssd_quadratic(*j_args, j_init)),
        (ref.ssd_chunked(*t_args, t_init, chunk=16), ref_ref.ssd_chunked(*j_args, j_init, chunk=16)),
    ):
        _close(got[0].numpy(), want[0])
        _close(got[1].numpy(), want[1])
    # the chunked scan and the quadratic form agree with each other
    _close(ref.ssd_chunked(*t_args, t_init, chunk=8)[0].numpy(),
           ref.ssd_quadratic(*t_args, t_init)[0].numpy(), 1e-4)


def test_decode_step_matches_reference():
    """The serving recurrence, step by step over a sequence, against the
    reference's, and its last step against the quadratic form."""
    b, s, h, p, g, n = 2, 12, 4, 16, 2, 8
    x, dt, A, Bm, Cm, D = _inputs(b, s, h, p, g, n, seed=13)
    st_t = torch.zeros((b, h, n, p))
    st_j = jnp.zeros((b, h, n, p))
    for t in range(s):
        step = (x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t], D)
        y_t, st_t = ref.ssd_decode_step(*(torch.tensor(a) for a in step), st_t)
        y_j, st_j = ref_ref.ssd_decode_step(*(jnp.asarray(a) for a in step), st_j)
        _close(y_t.numpy(), y_j)
        _close(st_t.numpy(), st_j)
    y_q, st_q = ref.ssd_quadratic(*(torch.tensor(a) for a in (x, dt, A, Bm, Cm, D)))
    _close(y_t.numpy(), y_q[:, -1].numpy(), 1e-4)
    _close(st_t.numpy(), st_q.numpy(), 1e-4)


def test_masked_decay_does_not_overflow():
    """A strongly decaying head makes exp(cum_t - cum_s) overflow above
    the diagonal; the select keeps y and the state finite, as the
    reference's ``where`` does."""
    x, dt, A, Bm, Cm, D = _inputs(1, 64, 2, 8, 1, 8, seed=14)
    dt[:] = 5.0
    A[:] = -40.0  # dA = -200 a step: exp(+200 * 63) is inf in float32
    y, st = ssd_scan(*(torch.tensor(a) for a in (x, dt, A, Bm, Cm, D)), chunk=64)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    want_y, want_st = ref_ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D)), chunk=64,
                                   impl="interpret")
    _close(y.numpy(), want_y)
    _close(st.numpy(), want_st)


def test_ssd_fwd_checks_its_inputs():
    x, dt, A, Bm, Cm, _ = (torch.tensor(a) for a in _inputs(1, 24, 2, 8, 1, 8, seed=15))
    xk, dtk = x.transpose(1, 2).contiguous(), dt.transpose(1, 2).contiguous()
    Bk, Ck = Bm.transpose(1, 2).contiguous(), Cm.transpose(1, 2).contiguous()
    with pytest.raises(ValueError, match="not divisible by chunk"):
        K.ssd_fwd(xk, dtk, dtk * A[None, :, None], Bk, Ck, chunk=16)
    with pytest.raises(ValueError, match="do not fit"):
        K.ssd_fwd(xk, dtk[:, :1], dtk * A[None, :, None], Bk, Ck, chunk=8)
    with pytest.raises(ValueError, match="do not fit"):  # 2 heads, 3 groups
        K.ssd_fwd(xk, dtk, dtk, Bk.expand(1, 3, 24, 8), Ck.expand(1, 3, 24, 8), chunk=8)


# ---------------------------------------------------------------------------
# Backward: the autograd Function (kernel forward, chunked-oracle backward)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES[:3])
def test_ssd_scan_gradients_match_reference_op(b, s, h, p, g, n, chunk):
    """float32: gradients of x, dt, A, Bm, Cm and D through the Function,
    with cotangents on y and on the final state, against jax.grad through
    the reference's Pallas op in interpret mode (whose custom VJP
    recomputes through ``ssd_chunked``), to 1e-5 of the largest."""
    import jax

    arrays = _inputs(b, s, h, p, g, n, seed=12)
    rng = np.random.default_rng(13)
    wy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    ws = rng.standard_normal((b, h, n, p)).astype(np.float32)

    def loss_ref(*a):
        y, state = ref_ssd_scan(*a, chunk=chunk, impl="interpret")
        return jnp.sum(y * wy) + jnp.sum(state * ws)

    want = jax.grad(loss_ref, argnums=tuple(range(6)))(*_as_jax(arrays))
    ts = [t.requires_grad_(True) for t in _as_torch(arrays)]
    y, state = ssd_scan(*ts, chunk=chunk)
    ((y * torch.tensor(wy)).sum() + (state * torch.tensor(ws)).sum()).backward()
    for t, w in zip(ts, want):
        assert t.grad.shape == t.shape
        _close(t.grad.numpy(), w)


def test_ssd_scan_backward_without_the_state():
    """A loss on y alone (the model drops the final state in training):
    the state's cotangent is zero and the gradients are those of the
    chunked oracle."""
    arrays = _inputs(1, 32, 2, 8, 1, 8, seed=14)
    ts = [t.requires_grad_(True) for t in _as_torch(arrays)]
    ssd_scan(*ts, chunk=8)[0].square().sum().backward()
    ts2 = [t.detach().clone().requires_grad_(True) for t in ts]
    ref.ssd_chunked(*ts2, chunk=8)[0].square().sum().backward()
    for a, b in zip(ts, ts2):
        _close(a.grad.numpy(), b.grad.numpy())
