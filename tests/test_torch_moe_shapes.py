"""The expert FFN at many experts and few rows (Kimi-K2's shapes), the
``moe_ffn_fwd`` kernel's contract and tiling, on the CPU.

``moe_ffn_fwd_torch`` (what the wrapper runs for a CPU tensor) against the
reference's Pallas ``moe_ffn_fwd`` in interpret mode at 48 experts with
caps 8 and 32, as Kimi-K2's 384 experts take at decode and prefill:
float32 to 1e-5 of the largest output (sums in another order), bfloat16
to 2e-2 (both round the activation and the output to bf16 at the same
places).  The kernel's contract (bf16, Dm and Dff multiples of 8, rows,
contiguous 16-byte aligned tensors) is checked on CPU tensors through the
checks the CUDA path runs, and the rows a CTA takes on each side of
``DECODE_MAX_ROWS`` at the serving shapes of Mixtral-8x22B and Kimi-K2.  The kernel
itself is held against the plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.moe_gemm import kernel as ref_kernel
from repro_torch.kernels.moe_gemm import kernel as K

def _inputs(e, c, dm, df, seed):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(shape)).astype(np.float32)
            for shape, scale in (((e, c, dm), 0.1), ((e, dm, df), 0.05), ((e, dm, df), 0.05),
                                 ((e, df, dm), 0.05))]


@pytest.mark.parametrize("cap", [8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel_many_experts(cap, dtype):
    arrays = _inputs(48, cap, 64, 128, seed=cap)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = ref_kernel.moe_ffn_fwd(*(jnp.asarray(a, jdt) for a in arrays), interpret=True)
    want = np.asarray(want.astype(jnp.float32), np.float64)
    inputs = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrays]
    K.launches["moe_ffn_fwd"] = 0
    for got in (K.moe_ffn_fwd_torch(*inputs), K.moe_ffn_fwd(*inputs)):
        assert got.dtype == getattr(torch, dtype) and got.shape == (48, cap, 64)
        err = float(np.max(np.abs(got.double().numpy() - want)))
        assert err <= (1e-5 if dtype == "float32" else 2e-2) * float(np.max(np.abs(want))), err
    assert K.launches["moe_ffn_fwd"] == 0  # the CPU runs the plain version


def _bf16(e=2, r=8, dm=16, dff=24):
    return [torch.tensor(a).bfloat16() for a in _inputs(e, r, dm, dff, seed=5)]


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype)
    start = next(i for i in range(1, 8) if (flat.data_ptr() + 2 * i) % 16)
    out = flat[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("case,error,match", [
    ("float32", TypeError, "bfloat16"),
    ("dm-not-multiple-of-8", ValueError, "multiples of 8"),
    ("dff-not-multiple-of-8", ValueError, "multiples of 8"),
    ("no-rows", ValueError, "multiples of 8 and rows"),
    ("misaligned-x", ValueError, "16-byte aligned"),
    ("misaligned-wd", ValueError, "16-byte aligned"),
    ("non-contiguous-wg", ValueError, "contiguous"),
])
def test_kernel_contract_refuses(case, error, match):
    x, wg, wu, wd = {
        "float32": lambda: [t.float() for t in _bf16()],
        "dm-not-multiple-of-8": lambda: _bf16(dm=20),
        "dff-not-multiple-of-8": lambda: _bf16(dff=20),
        "no-rows": lambda: _bf16(r=0),
    }.get(case, _bf16)()
    if case == "misaligned-x":
        x = _misaligned(x)
    if case == "misaligned-wd":
        wd = _misaligned(wd)
    if case == "non-contiguous-wg":
        wg = wg.transpose(1, 2).contiguous().transpose(1, 2)
    K._check(x, wg, wu, wd)  # the plain version takes all of these
    with pytest.raises(error, match=match):
        K._check_kernel(x, wg, wu, wd)


@pytest.mark.parametrize("shape", [(2, 8, 16, 24), (3, 130, 200, 264), (1, 1, 8, 8)])
def test_kernel_contract_accepts(shape):
    K._check_kernel(*_bf16(*shape))


@pytest.mark.parametrize("r,rows", [
    (1, 64), (8, 64), (K.DECODE_MAX_ROWS, 64),  # decode: Mixtral's and Kimi-K2's cap 8
    (K.DECODE_MAX_ROWS + 1, 128), (256, 128), (2560, 128),  # Kimi-K2's, Mixtral's prefill
])
def test_block_rows(r, rows):
    assert K.block_rows(r) == rows
