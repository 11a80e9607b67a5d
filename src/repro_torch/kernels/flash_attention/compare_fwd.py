"""Hold this tree's ``flash_fwd`` kernel against one built from another
``flash_fwd.cu`` (another checkout's) on the card: the instructions of
the kernels (``cuobjdump -sass``), their ptxas lines, their outputs bit
for bit and their times, at the serving shape (B=4, Hq=32, Hkv=8,
S=2048, causal) and every head dim of ``kernel.KERNEL_HEAD_DIMS`` (the
other source must take them all).  Given another
``flash_bwd.cu`` as well, it holds the instructions of this tree's
backward kernels against that one's too.

    python -m repro_torch.kernels.flash_attention.compare_fwd OTHER/flash_fwd.cu [OTHER/flash_bwd.cu]

Exits 1 unless the instructions and every output are equal.  Shows that
moving code between sources left the kernel as it was.  Needs a CUDA card
and ``nvcc``; the other library is built beside this tree's, in
``kernels/_build/``.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as K

SHAPE = (4, 32, 8, 2048)  # B, Hq, Hkv, S


def _sass(lib: Path) -> list[str]:
    """The instruction text of the flash_fwd kernels in ``lib``."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    return [m.group(1).strip() for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", out)]


def _events_ms(fn, reps: int = 10) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _build_other(stem: str, src: str) -> Path | None:
    """The library built from another source ``src``, or None if nvcc fails."""
    other = _build.BUILD_DIR / f"lib{stem}-other.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(other), src],
                          capture_output=True, text=True)
    print("\n".join(f"other {stem} ptxas: {line.strip()}" for line in proc.stdout.splitlines()
                    if "registers" in line or "spill" in line or "Potential" in line))
    if proc.returncode:
        print(proc.stdout + proc.stderr)
        return None
    return other


def main(other_src: str, other_bwd_src: str | None = None) -> int:
    _build.build_all()
    sources = _build._sources()
    this = _build._target("flash_fwd", sources["flash_fwd"][1])
    other = _build_other("flash_fwd", other_src)
    if other is None:
        return 1
    same_sass = _sass(this) == _sass(other)
    print(f"instructions equal: {same_sass} ({len(_sass(this))} instructions)")
    if other_bwd_src:
        this_bwd = _build._target("flash_bwd", sources["flash_bwd"][1])
        other_bwd = _build_other("flash_bwd", other_bwd_src)
        if other_bwd is None:
            return 1
        same_bwd = _sass(this_bwd) == _sass(other_bwd)
        print(f"flash_bwd instructions equal: {same_bwd} ({len(_sass(this_bwd))} instructions)")
        same_sass &= same_bwd
    lib = ctypes.CDLL(str(other))
    lib.flash_fwd_launch.argtypes = K._SIGNATURES["flash_fwd_launch"]
    b, hq, hkv, s = SHAPE
    ok = same_sass
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d in K.KERNEL_HEAD_DIMS[::-1]:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        o2, lse2 = torch.empty_like(q), torch.empty((b, hq, s), device="cuda")

        def mine():
            return K.flash_fwd(q, k, v, scale=d**-0.5, causal=True, window=None)

        def theirs():
            code = lib.flash_fwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o2.data_ptr(), lse2.data_ptr(), b,
                hq, hkv, s, s, d, d**-0.5, 1, 0, 0, torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"the other flash_fwd_launch returned {code}")

        times = [_events_ms(f) for f in (mine, theirs, theirs, mine)]  # in turns
        o, lse = mine()
        theirs()
        torch.cuda.synchronize()
        equal = bool(torch.equal(o, o2)) and bool(torch.equal(lse, lse2))
        ok &= equal
        print(f"D={d}: outputs bitwise equal: {equal}; ms this, other, other, this: "
              + ", ".join(f"{t:.4f}" for t in times))
    print(torch.cuda.get_device_name(0))
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) not in (2, 3) or not all(os.path.exists(a) for a in sys.argv[1:]):
        sys.exit("usage: python -m repro_torch.kernels.flash_attention.compare_fwd "
                 "OTHER/flash_fwd.cu [OTHER/flash_bwd.cu]")
    sys.exit(main(*sys.argv[1:]))
