"""Check and time this tree's ``ssd_fwd`` kernel on the card, in turns with
one built from another ``ssd_fwd.cu``: one whose launcher takes no scratch
(the kernel that walked the chunks of a (b, h) in order in one CTA), or
one whose launcher takes the increments and the decays (the kernel whose
y CTAs replayed the recurrence over the earlier chunks):

    python -m repro_torch.kernels.ssd_scan.compare [OTHER/ssd_fwd.cu]

Prints this source's ptxas lines (registers, spills, wgmma serialization).
Holds this kernel against the plain version (y's and the final state's
relative L2 error, to ``kernel.SSD_REL_L2`` and ``kernel.SSD_STATE_REL``)
at the three phase-1 shapes of ``chip_smoke.py``, at the Mamba2-1.3B
prefill shape (B=4, H=64, G=1, S=2048, N=128, P=64, chunk 256) and at a
long prompt of that model's widths (B=1, S=32768: 128 chunks), with a
second call bitwise equal to the first, and against the other kernel
there.  Times both at phase 1's first shape, the prefill shape and the
long prompt in turns (this, other, other, this; the median of calls timed
one by one behind a sleep on the card), and splits one call of this
kernel at the last two between its three launches under
``torch.profiler``.  Exits 1 if a check fails.  Needs a CUDA card
and ``nvcc``; the other library is built beside this tree's, in
``kernels/_build/``.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import kernel as SK

SLEEP_CYCLES = 100_000_000
#: (B, H, G, S, N, P, chunk): chip_smoke.py's phase-1 shapes, the prefill's
#: and a long prompt's.
SHAPES = ((2, 8, 2, 1024, 128, 64, 256), (1, 4, 1, 300, 64, 64, 100), (1, 6, 3, 96, 16, 24, 8),
          (4, 64, 1, 2048, 128, 64, 256), (1, 64, 1, 32768, 128, 64, 256))
#: Shapes timed, the first of them not split by the profiler.
TIMED = (SHAPES[0], SHAPES[3], SHAPES[4])


def inputs(b, h, g, s, n, p, seed=0):
    """As chip_smoke.ssd_inputs: x, B, C in bf16; dt in (0.01, 0.2) and
    dA = dt * A with A in (-2, -0.5), float32."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, h, s, p), generator=gen, device="cuda").to(torch.bfloat16)
    dt = 0.01 + 0.19 * torch.rand((b, h, s), generator=gen, device="cuda")
    a = -(0.5 + 1.5 * torch.rand((h,), generator=gen, device="cuda"))
    bm, cm = (torch.randn((b, g, s, n), generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    return x, dt, dt * a[None, :, None], bm, cm


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-300))


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


def launch_ms(fn) -> list[tuple[str, float]]:
    """(kernel, device ms) of each ssd launch of one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key.split("<")[0].split()[-1], e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and "ssd::" in e.key]


def other_kernel(src: str):
    """``ssd_fwd`` with the wrapper's signature, launching the kernel built
    from ``src``."""
    lib_path = _build.BUILD_DIR / "libssd_fwd-other.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    text = Path(src).read_text()
    scratch = [name for name in ("delta", "decay", "states") if f"float* {name}," in text]
    lib.ssd_fwd_launch.argtypes = ([ctypes.c_void_p] * (7 + len(scratch)) + [ctypes.c_int] * 7
                                   + [ctypes.c_void_p])

    def run(x, dt, da, bm, cm, *, chunk):
        b, h, s, p = x.shape
        g, n = bm.shape[1], bm.shape[-1]
        y = torch.empty_like(x)
        state = torch.empty((b, h, n, p), dtype=torch.float32, device="cuda")
        c = min(chunk, s)
        shapes = {"delta": (b * h, s // c, 64, 64 if n <= 64 else 128), "decay": (b * h, s // c)}
        shapes["states"] = shapes["delta"]  # as kernel.ssd_fwd allocates them
        bufs = [torch.empty(shapes[name], dtype=torch.float32, device="cuda") for name in scratch]
        extra = tuple(t.data_ptr() for t in bufs)
        code = lib.ssd_fwd_launch(x.data_ptr(), dt.data_ptr(), da.data_ptr(), bm.data_ptr(),
                                  cm.data_ptr(), y.data_ptr(), state.data_ptr(), *extra, b, h,
                                  g, s, n, p, c, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"the other ssd_fwd kernel returned {code}")
        return y, state

    return run


def main(other_src: str | None) -> int:
    logs = _build.build_all()
    print("\n".join(f"ptxas: {line.strip()}" for line in logs["ssd_fwd"].splitlines()
                    if any(key in line for key in ("Compiling entry", "registers", "spill",
                                                    "Potential Performance Loss"))))
    other = other_kernel(other_src) if other_src else None
    ok = True
    for shape in SHAPES:
        b, h, g, s, n, p, chunk = shape
        args = inputs(b, h, g, s, n, p)
        y, st = SK.ssd_fwd(*args, chunk=chunk)
        y2, st2 = SK.ssd_fwd(*args, chunk=chunk)
        same = bool(torch.equal(y, y2)) and bool(torch.equal(st, st2))
        y_p, st_p = SK.ssd_fwd_torch(*args, chunk=chunk)
        err_y, err_st = rel_l2(y, y_p), rel_l2(st, st_p)
        ok &= same and err_y <= SK.SSD_REL_L2 and err_st <= SK.SSD_STATE_REL
        line = (f"ssd_fwd (B, H, G, S, N, P, chunk)={shape}: second call equal {same}; against "
                f"the plain version y rel L2 {err_y:.3e}, state {err_st:.3e}")
        if other:
            y_o, st_o = other(*args, chunk=chunk)
            equal = bool(torch.equal(y, y_o)) and bool(torch.equal(st, st_o))
            line += (f"; against the other kernel (bitwise equal {equal}) y "
                     f"{rel_l2(y, y_o):.3e}, state "
                     f"{rel_l2(st, st_o):.3e}, its own against the plain version y "
                     f"{rel_l2(y_o, y_p):.3e}, state {rel_l2(st_o, st_p):.3e}")
        if shape in TIMED:
            mine = lambda: SK.ssd_fwd(*args, chunk=chunk)  # noqa: E731
            fns = [mine]
            if other:
                theirs = lambda: other(*args, chunk=chunk)  # noqa: E731
                fns = [mine, theirs, theirs, mine]
            for fn in fns:
                fn()  # warm up
            times = [median_ms(fn, 10) for fn in fns]
            line += ("; ms this, other, other, this: " if other else "; ms: ") + \
                ", ".join(f"{t:.4f}" for t in times)
            if shape != TIMED[0]:
                line += "; one call's launches (torch.profiler): " + ", ".join(
                    f"{name} {ms:.4f} ms" for name, ms in launch_ms(mine))
        print(line, flush=True)
        del args, y, y2, y_p, st, st2, st_p
        torch.cuda.empty_cache()
    print(torch.cuda.get_device_name(0))
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) > 2 or (len(sys.argv) == 2 and not Path(sys.argv[1]).exists()):
        sys.exit("usage: python -m repro_torch.kernels.ssd_scan.compare [OTHER/ssd_fwd.cu]")
    sys.exit(main(sys.argv[1] if len(sys.argv) == 2 else None))
