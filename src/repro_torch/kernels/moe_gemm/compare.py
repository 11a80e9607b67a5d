"""Check and time this tree's ``moe_ffn_fwd`` kernel on the card, alone or
in turns with one built from another ``moe_ffn.cu`` whose launchers take
no tile arguments (the earlier mma.sync kernel's interface):

    python -m repro_torch.kernels.moe_gemm.compare [OTHER/moe_ffn.cu]

Prints this kernel's ptxas lines (registers, spills, serialized wgmma),
holds it against the plain version at small shapes on both sides of
``DECODE_MAX_ROWS`` and at widths no tile divides, with a second call
bitwise equal to the first, then times it (the median of calls timed one
by one behind a sleep on the card) at the serving shapes of Mixtral-8x22B
and Kimi-K2, the other kernel in turns (this, other, other, this), and
holds both against the plain version there.  Exits 1 if a check fails.
Needs a CUDA card and ``nvcc``; the other library is built beside this
tree's, in ``kernels/_build/``.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_gemm import kernel as K

#: (E, R, Dm, Dff): both tilings of the kernel, ragged widths and rows.
SMALL = ((8, 320, 1024, 2048), (8, 8, 1024, 2048), (3, 130, 200, 264), (3, 5, 200, 264),
         (48, 8, 1024, 256), (48, 72, 1024, 256), (8, K.DECODE_MAX_ROWS, 512, 1024),
         (8, K.DECODE_MAX_ROWS + 1, 512, 1024))
#: Mixtral-8x22B's prefill and decode, Kimi-K2's prefill and decode.
SERVING = ((8, 2560, 6144, 16384), (8, 8, 6144, 16384), (384, 256, 7168, 2048),
           (384, 8, 7168, 2048))
REL_L2 = 1e-2
SLEEP_CYCLES = 100_000_000


def inputs(e, r, dm, dff, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(shape, std):
        out = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        for i in range(0, shape[0], 16):
            part = out[i:i + 16]
            part.copy_(torch.randn(part.shape, generator=gen, device="cuda").mul_(std))
        return out

    return (draw((e, r, dm), 1.0), draw((e, dm, dff), dm**-0.5), draw((e, dm, dff), dm**-0.5),
            draw((e, dff, dm), dff**-0.5))


def plain(x, wg, wu, wd, budget=16 << 30):
    step = max(1, min(x.shape[0], budget // (3 * x.shape[2] * wg.shape[2] * 4)))
    return torch.cat([K.moe_ffn_fwd_torch(x[i:i + step], wg[i:i + step], wu[i:i + step],
                                          wd[i:i + step]) for i in range(0, x.shape[0], step)])


def rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm())


def median_ms(fn, reps):
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    events[-1][1].synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def other_kernel(src: str):
    """``fn(x, wg, wu, wd) -> out`` launching the kernel built from ``src``."""
    lib_path = _build.BUILD_DIR / "libmoe_ffn-other.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.moe_gate_up_launch.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.moe_down_launch.argtypes = [p, p, p, i, i, i, i, p]

    def fn(x, wg, wu, wd):
        e, r, dm = x.shape
        dff = wg.shape[-1]
        act = torch.empty((e, r, dff), dtype=x.dtype, device=x.device)
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        for code in (lib.moe_gate_up_launch(x.data_ptr(), wg.data_ptr(), wu.data_ptr(),
                                            act.data_ptr(), e, r, dm, dff, stream),
                     lib.moe_down_launch(act.data_ptr(), wd.data_ptr(), out.data_ptr(), e, r,
                                         dm, dff, stream)):
            if code:
                raise RuntimeError(f"the other moe_ffn kernel returned {code}")
        return out

    return fn


def main(other_src: str | None) -> int:
    logs = _build.build_all()
    print("\n".join(f"ptxas: {line.strip()}" for line in logs["moe_ffn"].splitlines()
                    if any(key in line for key in ("Compiling entry", "registers", "spill",
                                                   "Potential"))))
    ok = True
    for shape in SMALL:
        args = inputs(*shape)
        got, again, want = K.moe_ffn_fwd(*args), K.moe_ffn_fwd(*args), plain(*args)
        err, same = rel_l2(got, want), bool(torch.equal(got, again))
        ok &= err <= REL_L2 and same and bool(torch.isfinite(got.float()).all())
        print(f"{shape} rows a CTA {K.block_rows(shape[1])}: rel L2 {err:.3e}, second call "
              f"equal {same}")
    other = other_kernel(other_src) if other_src else None
    for shape in SERVING:
        args = inputs(*shape, seed=2)
        reps = 3 if shape[1] > K.DECODE_MAX_ROWS else 10
        mine = lambda: K.moe_ffn_fwd(*args)
        theirs = lambda: other(*args)
        fns = [mine, theirs, theirs, mine] if other else [mine]
        for fn in fns:
            fn()  # warm up
        times = [median_ms(fn, reps) for fn in fns]
        want = plain(*args)
        got = mine()
        err = rel_l2(got, want)
        ok &= err <= REL_L2 and bool(torch.equal(got, mine()))
        line = f"{shape} rows a CTA {K.block_rows(shape[1])}: rel L2 {err:.3e}"
        if other:
            line += f", other's {rel_l2(other(*args), want):.3e}; ms this, other, other, this: "
        else:
            line += "; ms: "
        print(line + ", ".join(f"{t:.4f}" for t in times), flush=True)
        del args, want, got
        torch.cuda.empty_cache()
    print(torch.cuda.get_device_name(0))
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) > 2 or (len(sys.argv) == 2 and not os.path.exists(sys.argv[1])):
        sys.exit("usage: python -m repro_torch.kernels.moe_gemm.compare [OTHER/moe_ffn.cu]")
    sys.exit(main(sys.argv[1] if len(sys.argv) == 2 else None))
