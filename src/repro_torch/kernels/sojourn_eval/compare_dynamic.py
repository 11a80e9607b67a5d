"""Check and time this tree's dynamic sojourn kernel on the card, alone or
in turns with one built from another ``sojourn_dynamic.cu`` with the
launchers of the per-job register kernel (before the ranked queue):

    python -m repro_torch.kernels.sojourn_eval.compare_dynamic [OTHER/sojourn_dynamic.cu]

Prints this kernel's ptxas lines (registers, spills), holds it against the
plain version at small shapes on each of its paths (registers, shared
memory, device scratch), with a second call bitwise equal to the first,
then times it (the median of calls timed one by one behind a sleep on the
card) at the main path's shapes -- N=26 K=2^26, N=27 S=2^23 and N=80
S=2^20, SR on one server -- the other kernel in turns (this, other, other,
this), and prints the largest relative difference between the two
kernels' results there.  Last it times this kernel at the first two
shapes on grids of half, once and twice ``kernel.TARGET_BLOCKS`` blocks
(the sums then differ only in order).  Exits 1 if a check fails.  Needs
a CUDA card and ``nvcc``; the other library is built beside this tree's,
in ``kernels/_build/``, against this tree's headers (``common.cuh``,
``threefry.cuh``).
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from repro_torch.core import policies
from repro_torch.core.jobs import JobSpec, generate_workload
from repro_torch.kernels import _build
from repro_torch.kernels.sojourn_eval import dynamic as D
from repro_torch.kernels.sojourn_eval import kernel as K

RTOL = 1e-9
SEED = 0x5EED_CAFE
SLEEP_CYCLES = 100_000_000
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")


def args_for(jobs, policy, samples=None, dev="cuda"):
    _, probs, num_stages = policies.padded_arrays(jobs)
    return D.dynamic_kernel_args(probs, policies.stage_durations(jobs), num_stages,
                                 policies.index_table(jobs, policy)[None], torch.device(dev),
                                 samples)


def mixed_group(n, two_stage, seed):
    """``n`` jobs, the first ``two_stage`` of two stages and the rest of one."""
    rng = np.random.default_rng(seed)
    jobs = []
    for i in range(n):
        first = float(rng.uniform(0.5, 3.0))
        two = i < two_stage
        jobs.append(JobSpec(sizes=[first, first + 1.5] if two else [first],
                            probs=[0.3, 0.7] if two else [1.0], job_id=i))
    return jobs


def rel(got, want) -> float:
    got = torch.stack(list(got)).cpu().numpy()
    want = torch.stack(list(want)).cpu().numpy()
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))


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
    """``(enum, mc)`` launching the kernels built from ``src``, with the
    wrappers' signatures: per-job state in registers up to 64 jobs, past
    that 16 bytes a job and thread of scratch on ``SCRATCH_BLOCKS`` blocks."""
    lib_path = _build.BUILD_DIR / "libsojourn_dynamic-other.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o", str(lib_path),
                           src], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    lib.dynamic_enum_launch.argtypes = [p, p, p, p, p, i, i, i, ll, i, i, p, i, p, p, p]
    lib.dynamic_mc_launch.argtypes = [p, p, p, p, i, i, i, ll, u, u, i, i, p, i, p, p, p]

    def run(entry, count, n_pols, n, head, tail):
        scratch_bytes = 16 * n if n > 64 else 0
        nblk = K.blocks_per_order(count, n_pols,
                                  K.SCRATCH_BLOCKS if scratch_bytes else K.TARGET_BLOCKS)
        scratch = torch.empty(n_pols * nblk * K.THREADS * scratch_bytes, dtype=torch.uint8,
                              device="cuda") if scratch_bytes else None
        partials = torch.empty((n_pols, nblk, 2), dtype=torch.float64, device="cuda")
        out = torch.empty((2, n_pols), dtype=torch.float64, device="cuda")
        code = entry(*head, *tail, scratch.data_ptr() if scratch is not None else None, nblk,
                     partials.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"the other dynamic kernel returned {code}")
        return out[0], out[1]

    def enum(probs, durs, tables, strides, radix, k_total, total_stages, *, n_servers=1):
        p_pols, n, m = tables.shape
        return run(lib.dynamic_enum_launch, k_total, p_pols, n,
                   (probs.data_ptr(), durs.data_ptr(), tables.data_ptr(), strides.data_ptr(),
                    radix.data_ptr()),
                   (p_pols, n, m, k_total, total_stages, min(n_servers, n)))

    def mc(cdf, durs, tables, radix, seed, n_samples, total_stages, *, n_servers=1):
        from repro_torch.kernels.sojourn_eval import rng

        p_pols, n, m = tables.shape
        k0, k1 = rng.split_seed(seed)
        return run(lib.dynamic_mc_launch, n_samples, p_pols, n,
                   (cdf.data_ptr(), durs.data_ptr(), tables.data_ptr(), radix.data_ptr()),
                   (p_pols, n, m, n_samples, k0, k1, total_stages, min(n_servers, n)))

    return enum, mc


def small_cases():
    """(label, MC?, args, n_servers) on each path and at each limit."""
    j16 = generate_workload(np.random.default_rng(16), 16)
    j129 = generate_workload(np.random.default_rng(129), 129)
    return [
        ("N=16 K=2^16 W=1, registers", False, args_for(j16, "sr"), 1),
        ("N=16 K=2^16 W=3, registers", False, args_for(j16, "serpt"), 3),
        ("N=16 S=2^16 W=16, shared memory", True, args_for(j16, "sr", (SEED, 1 << 16)), 16),
        ("N=32 (16 of two stages) K=2^16 W=2, 64 entries", False,
         args_for(mixed_group(32, 16, 32), "sr"), 2),
        ("N=129 S=2^14 W=1, 258 entries: shared memory", True,
         args_for(j129, "sr", (SEED, 1 << 14)), 1),
        ("N=30 (10 of two stages) K=2^10 W=30, scratch", False,
         args_for(mixed_group(30, 10, 30), "serpt"), 30),
    ]


def main(other_src: str | None) -> int:
    logs = _build.build_all()
    print("\n".join(f"ptxas: {line.strip()}" for line in logs["sojourn_dynamic"].splitlines()
                    if any(key in line for key in ("Compiling entry", "registers", "spill"))))
    ok = True
    for label, mc, args, w in small_cases():
        kernel = D.dynamic_sojourn_mc if mc else D.dynamic_sojourn_enum
        plain = D.dynamic_sojourn_mc_torch if mc else D.dynamic_sojourn_enum_torch
        got, again = kernel(*args, n_servers=w), kernel(*args, n_servers=w)
        err = rel(got, plain(*args, n_servers=w))
        same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
        ok &= err <= RTOL and same
        print(f"{label}: rel err {err:.3e} against the plain version, second call equal {same}")
    other = other_kernel(other_src) if other_src else None
    j26 = generate_workload(np.random.default_rng(31), 26, 2)
    j27 = generate_workload(np.random.default_rng(27), 27, 2)
    j80 = generate_workload(np.random.default_rng(80), 80, 2)
    main_shapes = (
        ("N=26 M=2 K=2^26 SR W=1", False, args_for(j26, "sr"), 1),
        ("N=27 M=2 S=2^23 SR W=1", True, args_for(j27, "sr", (SEED, 1 << 23)), 3),
        ("N=80 M=2 S=2^20 SR W=1", True, args_for(j80, "sr", (SEED, 1 << 20)), 3),
    )
    for label, mc, args, reps in main_shapes:
        kernel = D.dynamic_sojourn_mc if mc else D.dynamic_sojourn_enum
        mine = lambda: kernel(*args)  # noqa: E731
        fns = [mine]
        if other:
            theirs = lambda: other[mc](*args)  # noqa: E731
            fns = [mine, theirs, theirs, mine]
        for fn in fns:
            fn()  # warm up
        times = [median_ms(fn, reps) for fn in fns]
        got = mine()
        same = all(bool(torch.equal(a, b)) for a, b in zip(got, mine()))
        ok &= same and bool(torch.isfinite(torch.stack(list(got))).all())
        line = f"{label}: e_succ {got[0].item()!r}, second call equal {same}"
        if other:
            diff = rel(got, other[mc](*args))
            ok &= diff <= RTOL
            line += f", largest rel diff from the other kernel {diff:.3e}; ms this, other, " \
                    "other, this: "
        else:
            line += "; ms: "
        print(line + ", ".join(f"{t:.4f}" for t in times), flush=True)
    target = K.TARGET_BLOCKS
    for label, mc, args, _ in main_shapes[:2]:
        kernel = D.dynamic_sojourn_mc if mc else D.dynamic_sojourn_enum
        want = kernel(*args)
        for blocks in (target // 2, target, 2 * target, target):
            K.TARGET_BLOCKS = blocks
            kernel(*args)  # warm up
            ms = median_ms(lambda: kernel(*args), 3)  # noqa: B023
            diff = rel(kernel(*args), want)
            ok &= diff <= RTOL
            print(f"{label} on {blocks} blocks: {ms:.4f} ms, rel diff {diff:.3e}", flush=True)
        K.TARGET_BLOCKS = target
    print(torch.cuda.get_device_name(0))
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) > 2 or (len(sys.argv) == 2 and not os.path.exists(sys.argv[1])):
        sys.exit("usage: python -m repro_torch.kernels.sojourn_eval.compare_dynamic "
                 "[OTHER/sojourn_dynamic.cu]")
    sys.exit(main(sys.argv[1] if len(sys.argv) == 2 else None))
