"""Per-expert SwiGLU FFN: the CUDA kernel's wrapper, launch count and
plain version.

``moe_ffn_fwd`` replaces the TPU kernel of the same name in
``repro/kernels/moe_gemm/kernel.py``; its CUDA source is
``csrc/moe_ffn.cu`` (design note there).  x (E, R, Dm) holds each
expert's dispatched rows (any R: the model folds its dispatch groups
into the rows); wg and wu (E, Dm, Dff), wd (E, Dff, Dm).  It computes
``(silu(x·wg) * (x·wu))·wd`` with both inner products summed in float32,
the activation rounded to x's type before the down product and the
output in x's type: the Pallas kernel's numbers up to the order of the
sums.

Dispatch is by device: a CUDA tensor launches the kernel (two launches a
call: gate-up, then down; bf16, Dm and Dff multiples of 8) or raises; a
CPU tensor runs the plain PyTorch version, :func:`moe_ffn_fwd_torch`.
``launches`` counts kernel launches and nothing else, so one call adds 2.
:func:`block_rows` picks the kernel's tiles from R: the prefill tiles
(128 rows a CTA) above ``DECODE_MAX_ROWS`` rows an expert, the decode
tiles (64 rows, a deeper ring of weight tiles) at or below it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

__all__ = ["DECODE_MAX_ROWS", "block_rows", "launches", "moe_ffn_fwd", "moe_ffn_fwd_torch"]

#: Kernel launches since the last reset (set to 0 to reset); two a call.
launches = {"moe_ffn_fwd": 0}

#: Rows an expert at most for the decode tiles (one consumer warpgroup of
#: 64 rows a CTA); more take the prefill tiles (two, 128 rows).
DECODE_MAX_ROWS = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "moe_gate_up_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "moe_down_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def block_rows(r: int) -> int:
    """Rows a CTA of the kernel takes for R rows an expert: 128 (two
    consumer warpgroups, 256-wide B tiles) above DECODE_MAX_ROWS, else 64
    (one consumer, a ring of 5 or 9 weight tiles for gate-up and down)."""
    return 128 if r > DECODE_MAX_ROWS else 64


def _check(x, wg, wu, wd):
    for name, t in (("x", x), ("wg", wg), ("wu", wu), ("wd", wd)):
        if not isinstance(t, torch.Tensor) or t.dim() != 3:
            raise ValueError(f"{name} must be a 3-d tensor")
    e, _, dm = x.shape
    dff = wg.shape[-1]
    if wg.shape != (e, dm, dff) or wu.shape != wg.shape or wd.shape != (e, dff, dm):
        raise ValueError(f"wg {tuple(wg.shape)}, wu {tuple(wu.shape)}, wd {tuple(wd.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if len({t.device for t in (x, wg, wu, wd)}) != 1:
        raise ValueError("x, wg, wu, wd must be on one device")
    if len({t.dtype for t in (x, wg, wu, wd)}) != 1:
        raise TypeError("x, wg, wu, wd must have one dtype")


def _check_kernel(x, wg, wu, wd):
    """What the kernel takes beyond :func:`_check`: bf16, rows, Dm and Dff
    multiples of 8 (its tensor maps' strides are multiples of 16 bytes),
    contiguous tensors at 16-byte aligned addresses."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the moe_ffn_fwd kernel takes bfloat16; got {x.dtype}")
    _, r, dm = x.shape
    dff = wg.shape[-1]
    if dm % 8 or dff % 8 or r == 0:
        raise ValueError(f"the moe_ffn_fwd kernel takes Dm and Dff multiples of 8 and rows; "
                         f"got R={r}, Dm={dm}, Dff={dff}")
    for name, t in (("x", x), ("wg", wg), ("wu", wu), ("wd", wd)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def moe_ffn_fwd_torch(x, wg, wu, wd):
    """Plain version of :func:`moe_ffn_fwd` on any device: float32 sums of
    exact products (bf16 x bf16 is exact in float32), act rounded to x's
    type, as the kernel."""
    _check(x, wg, wu, wd)
    xf = x.float()
    act = F.silu(torch.bmm(xf, wg.float())) * torch.bmm(xf, wu.float())
    return torch.bmm(act.to(x.dtype).float(), wd.float()).to(x.dtype)


def moe_ffn_fwd(
    x: torch.Tensor,  # (E, R, Dm)
    wg: torch.Tensor,  # (E, Dm, Dff)
    wu: torch.Tensor,  # (E, Dm, Dff)
    wd: torch.Tensor,  # (E, Dff, Dm)
) -> torch.Tensor:
    """out (E, R, Dm) in x's type."""
    _check(x, wg, wu, wd)
    dev = x.device
    if dev.type == "cpu":
        return moe_ffn_fwd_torch(x, wg, wu, wd)
    if dev.type != "cuda":
        raise ValueError(f"moe_ffn_fwd launches on a CUDA device; got {dev}")
    _check_kernel(x, wg, wu, wd)
    e, r, dm = x.shape
    dff = wg.shape[-1]
    rows = block_rows(r)
    lib = _build.library("moe_ffn", _SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        act = torch.empty((e, r, dff), dtype=x.dtype, device=dev)
        out = torch.empty_like(x)
        code = lib.moe_gate_up_launch(x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                                      act.data_ptr(), e, r, dm, dff, rows, stream)
        _build.check(lib, code, "moe_gate_up_launch")
        launches["moe_ffn_fwd"] += 1
        code = lib.moe_down_launch(act.data_ptr(), wd.data_ptr(), out.data_ptr(), e, r, dm,
                                   dff, rows, stream)
        _build.check(lib, code, "moe_down_launch")
        launches["moe_ffn_fwd"] += 1
    return out
