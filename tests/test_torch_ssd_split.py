"""The ``ssd_fwd`` kernel's arithmetic, modelled on the CPU.

``csrc/ssd_fwd.cu`` runs every chunk at once: each chunk's state
increment Delta_c = Bᵀ·(x * w), then a pass over the chunks of each
(b, h) (state_{c+1} = exp(cum_last_c) * state_c + Delta_c), then y; and
every product runs on wgmma with bf16 operands.  The three products with
a float32 operand (the masked scores by x, C by the state, B by x * w)
take that operand as hi = bf16(v) plus lo = bf16(v - hi), two bf16
products into one float32 sum; the other operand (x, C or B) is bf16 as
the model feeds it.  A CUDA kernel does not run here, so ``_chunk_parallel``
is that arithmetic in plain PyTorch (float32 sums, the split optional):

* without the split it equals the plain version ``ssd_fwd_torch`` and the
  reference's Pallas ``ssd_fwd`` in interpret mode within 1e-5 of the
  largest magnitude (float32 sums in another order);
* with the split it is within 1e-5 of itself without: the most that the
  split adds to float32;
* the split keeps every float32 value within 2^-16 relative;
* ``chip_smoke.ssd_work``, the kernel's bound, against a count by hand.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import kernel as ref_kernel
from repro_torch.kernels.ssd_scan import kernel as K

RTOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want)))
    assert float(np.max(np.abs(got - want))) <= rtol * scale, (
        float(np.max(np.abs(got - want))), scale)


def _split(v):
    """hi = bf16(v) and lo = bf16(v - hi), as float32."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _mm(a, b, split_a=False, split_b=False):
    """a @ b in float32; the operand marked split as hi + lo, two products."""
    if split_a:
        hi, lo = _split(a)
        return hi @ b + lo @ b
    if split_b:
        hi, lo = _split(b)
        return a @ hi + a @ lo
    return a @ b


def _chunk_parallel(x, dt, da, Bm, Cm, chunk, split):
    """The kernel's arithmetic in its layout (x (B, H, S, P), dt and dA
    (B, H, S), Bm and Cm (B, G, S, N)): y (B, H, S, P) and the final state
    (B, H, N, P), float32."""
    b, h, s, p = x.shape
    n = Bm.shape[-1]
    nc = s // chunk
    groups = h // Bm.shape[1]
    xs = x.float().reshape(b, h, nc, chunk, p)
    dts = dt.float().reshape(b, h, nc, chunk)
    bs = torch.repeat_interleave(Bm.float(), groups, dim=1).reshape(b, h, nc, chunk, n)
    cs = torch.repeat_interleave(Cm.float(), groups, dim=1).reshape(b, h, nc, chunk, n)
    cum = torch.cumsum(da.float().reshape(b, h, nc, chunk), dim=-1)
    w = torch.exp(cum[..., -1:] - cum) * dts
    # 1. each chunk's increment, transposed as the kernel keeps it: (P, N)
    delta_t = _mm((xs * w[..., None]).transpose(-1, -2), bs, split_a=split)
    decay = torch.exp(cum[..., -1])
    # 2. the pass over the chunks: the state entering each chunk
    state = torch.zeros((b, h, p, n))
    entering = []
    for c in range(nc):
        entering.append(state)
        state = decay[..., c, None, None] * state + delta_t[:, :, c]
    entering = torch.stack(entering, dim=2)  # (B, H, nc, P, N)
    # 3. y: the carried term and the masked scores of the chunk
    carried = _mm(cs, entering.transpose(-1, -2), split_b=split) * torch.exp(cum)[..., None]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    decay_mask = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]), 0.0)
    scores = (cs @ bs.transpose(-1, -2)) * decay_mask * dts[..., None, :]
    y = carried + _mm(scores, xs, split_a=split)
    return y.reshape(b, h, s, p), state.transpose(-1, -2)


def _inputs(b, h, g, s, n, p, seed):
    """Kernel-layout inputs: x, B, C rounded to bf16 (as the model feeds
    the kernel), kept in float32; dt in (0.01, 0.2), dA = dt * A."""
    rng = np.random.default_rng(seed)

    def bf16(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32).bfloat16().float()

    x = bf16((b, h, s, p))
    dt = torch.tensor(rng.uniform(0.01, 0.2, (b, h, s)), dtype=torch.float32)
    A = -torch.tensor(rng.uniform(0.5, 2.0, (h,)), dtype=torch.float32)
    return x, dt, dt * A[None, :, None], bf16((b, g, s, n)), bf16((b, g, s, n))


# (B, H, G, S, N, P, chunk): one and several groups and chunks, widths no
# multiple of 16, a chunk of the whole sequence
CASES = [
    pytest.param(2, 4, 1, 64, 8, 16, 16, id="g1-4chunks"),
    pytest.param(2, 4, 2, 128, 16, 32, 32, id="g2-4chunks"),
    pytest.param(1, 6, 3, 96, 16, 24, 8, id="g3-12chunks"),
    pytest.param(1, 4, 2, 100, 24, 8, 25, id="g2-ragged-widths"),
    pytest.param(1, 2, 1, 48, 16, 16, 48, id="g1-1chunk"),
]


@pytest.mark.parametrize("b,h,g,s,n,p,chunk", CASES)
def test_chunk_parallel_model_matches_plain_and_reference(b, h, g, s, n, p, chunk):
    args = _inputs(b, h, g, s, n, p, seed=s + n)
    y, st = _chunk_parallel(*args, chunk, split=False)
    y_plain, st_plain = K.ssd_fwd_torch(*args, chunk=chunk)
    _close(y, y_plain)
    _close(st, st_plain)
    want_y, want_st = ref_kernel.ssd_fwd(*(jnp.asarray(a.numpy()) for a in args), chunk=chunk,
                                         interpret=True)
    _close(y, np.asarray(want_y))
    _close(st, np.asarray(want_st))


@pytest.mark.parametrize("b,h,g,s,n,p,chunk", CASES)
def test_split_products_stay_within_float32(b, h, g, s, n, p, chunk):
    """hi + lo in each of the three float32-operand products moves y and
    the final state by at most 1e-5 of their largest magnitude from the
    float32 products, and from the plain version."""
    args = _inputs(b, h, g, s, n, p, seed=s + n + 1)
    y, st = _chunk_parallel(*args, chunk, split=True)
    y32, st32 = _chunk_parallel(*args, chunk, split=False)
    _close(y, y32)
    _close(st, st32)
    y_plain, st_plain = K.ssd_fwd_torch(*args, chunk=chunk)
    _close(y, y_plain)
    _close(st, st_plain)


def test_split_keeps_sixteen_bits():
    rng = np.random.default_rng(3)
    v = torch.tensor(rng.standard_normal(1 << 16) * 10.0 ** rng.uniform(-20, 20, 1 << 16),
                     dtype=torch.float32)
    hi, lo = _split(v)
    err = ((hi + lo).double() - v.double()).abs()
    assert bool((err <= 2.0**-16 * v.double().abs()).all())
    assert bool((hi == v.bfloat16().float()).all())  # hi alone keeps 8 bits


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_ssd_work_counts_by_hand():
    """(B, H, G, S, N, P, chunk) = (1, 2, 1, 8, 16, 8, 4): 4 chunks of 10
    visible pairs each."""
    cs = _chip_smoke()
    work = cs.ssd_work(1, 2, 1, 8, 16, 8, 4)
    visible = sum(1 for t in range(4) for s_ in range(4) if t >= s_)
    assert visible == 10
    chunks = 1 * 2 * (8 // 4)
    assert work["bf16"] == chunks * visible * 2 * 16  # C·Bᵀ
    # scores·x, C·state and Bᵀ·(x w)
    assert work["tf32"] == chunks * (visible * 2 * 8 + 2 * (2 * 4 * 16 * 8))
    assert work["f32"] == chunks * visible * 4  # exp, subtract, two multiplies
    # x and y bf16; dt, dA f32; B, C bf16; the state f32
    assert work["bytes"] == 2 * (2 * 8 * 8 * 2) + 2 * (2 * 8 * 4) + 2 * (8 * 16 * 2) + 2 * 16 * 8 * 4
    ms, by = cs.ssd_bound(work)
    assert by == "bytes" and ms == work["bytes"] / cs.HBM_BYTES_PER_S * 1e3


def test_ssd_bound_at_the_prefill_shape():
    """Mamba2-1.3B's prefill scan: the tensor cores bound it, C·Bᵀ at the
    bf16 rate and the three float32-operand products at the TF32 rate; the
    bound with those three on the float32 vector units is 5.5 times as long."""
    cs = _chip_smoke()
    work = cs.ssd_work(4, 64, 1, 2048, 128, 64, 256)
    ms, by = cs.ssd_bound(work)
    assert by == "operations"
    assert ms == pytest.approx((work["bf16"] / 989e12 + work["tf32"] / 495e12) * 1e3)
    assert 0.069 < ms < 0.071
    old_ms, _ = cs.ssd_bound_cuda_cores(work)
    assert 0.38 < old_ms < 0.39
