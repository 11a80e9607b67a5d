"""Check and time this tree's static sojourn kernels on the card, in turns
with those built from another ``sojourn_static.cu`` whose enumeration
launcher takes the mixed-radix strides and the combination count (the
kernel that decoded every combination on its own):

    python -m repro_torch.kernels.sojourn_eval.compare_static OTHER/sojourn_static.cu

Prints this source's ptxas lines (registers, spills).  Holds this
enumeration kernel against the plain version and against the other
kernel, to 1e-12 relative, at N=26 K=2^26 P=1 (RANK) and at N=8 M=3
K=3^8 P=512 (a batch of the OPTIMAL search), with a second call bitwise
equal to the first; holds ``sojourn_mc`` (N=27 S=2^23) and
``sojourn_outcomes`` (N=21, the K=2^21 table) bitwise equal to the other
source's.  Times both enumerations at both shapes in turns (this, other,
other, this; the median of calls timed one by one behind a sleep on the
card).  Last it drives the N=8 OPTIMAL cell of ``chip_smoke.py``'s phase 3
(``evaluate_many`` on the seed-8 group of 8 three-stage jobs, OPTIMAL,
RANK, SERPT and SR) with each enumeration kernel in turns: its host wall
(results on the host) and, in one more run under ``torch.profiler``, the
enumeration kernel's time summed over its launches and all device time.
Exits 1 if a check fails.  Needs a CUDA card and ``nvcc``; the other
library is built beside this tree's, in ``kernels/_build/``, against this
tree's headers (``common.cuh``, ``threefry.cuh``).
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.core import evaluator, policies
from repro_torch.core.jobs import generate_workload
from repro_torch.kernels import _build
from repro_torch.kernels.sojourn_eval import kernel as K
from repro_torch.kernels.sojourn_eval import ops

RTOL = 1e-12
SEED = 0x5EED_CAFE
SLEEP_CYCLES = 100_000_000
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")


def rel(got, want) -> float:
    got = torch.stack(list(got)).cpu().numpy()
    want = torch.stack(list(want)).cpu().numpy()
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))


def equal(a, b) -> bool:
    return all(bool(torch.equal(x, y)) for x, y in zip(a, b))


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


def other_kernels(src: str):
    """``(enum, mc, outcomes)`` launching the kernels built from ``src``,
    each with its wrapper's signature and grid."""
    lib_path = _build.BUILD_DIR / "libsojourn_static-other.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o", str(lib_path),
                           src], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    lib.sojourn_enum_launch.argtypes = [p, p, p, p, i, i, i, ll, i, p, p, p]
    lib.sojourn_mc_launch.argtypes = [p, p, p, p, i, i, i, ll, u, u, i, p, p, p]
    lib.sojourn_outcomes_launch.argtypes = [p, p, p, p, p, i, i, i, ll, i, p, p, p]

    def run(entry, n_orders, count, args, rows=None):
        nblk = K.blocks_per_order(count, rows or n_orders)
        partials = torch.empty((n_orders, nblk, 2), dtype=torch.float64, device="cuda")
        out = torch.empty((2, n_orders), dtype=torch.float64, device="cuda")
        code = entry(*args, nblk, partials.data_ptr(), out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"the other static kernel returned {code}")
        return out[0], out[1]

    def enum(sizes_p, probs_p, strides_p, radix_p, k_total):
        p_orders, n, m = sizes_p.shape
        return run(lib.sojourn_enum_launch, p_orders, k_total,
                   (sizes_p.data_ptr(), probs_p.data_ptr(), strides_p.data_ptr(),
                    radix_p.data_ptr(), p_orders, n, m, k_total))

    def mc(sizes_p, cdf_p, radix_p, orders, seed, n_samples):
        from repro_torch.kernels.sojourn_eval import rng

        p_orders, n, m = sizes_p.shape
        k0, k1 = rng.split_seed(seed)
        return run(lib.sojourn_mc_launch, p_orders, n_samples,
                   (sizes_p.data_ptr(), cdf_p.data_ptr(), orders.data_ptr(), radix_p.data_ptr(),
                    p_orders, n, m, n_samples, k0, k1))

    def outcomes(sizes_p, radix_p, orders, outcomes_t, weights):
        p_orders, n, m = sizes_p.shape
        k_total = weights.shape[0]
        return run(lib.sojourn_outcomes_launch, p_orders, k_total,
                   (sizes_p.data_ptr(), radix_p.data_ptr(), orders.data_ptr(),
                    outcomes_t.data_ptr(), weights.data_ptr(), p_orders, n, m, k_total),
                   rows=-(-p_orders // K.OUTCOMES_CHUNK))

    return enum, mc, outcomes


def static_args(jobs, orders, samples=None):
    return ops.static_kernel_args(*policies.padded_arrays(jobs), orders, torch.device("cuda"),
                                  samples)


def optimal_cell(enum_fn, key: str) -> tuple[float, float | None, int, float | None]:
    """(host seconds of the N=8 OPTIMAL cell with ``enum_fn`` as the
    enumeration, then the profiled run's kernel ms of ``key``, its launches
    and all device ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(8)
    jobs = generate_workload(rng, 8, 3)
    algs = ("optimal", "rank", "serpt", "sr")
    mine = K.sojourn_enum
    K.sojourn_enum = enum_fn
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluator.evaluate_many(jobs, algs, rng, mc_samples=4096)
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            evaluator.evaluate_many(jobs, algs, np.random.default_rng(8), mc_samples=4096)
            torch.cuda.synchronize()
    finally:
        K.sojourn_enum = mine
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    hits = [e for e in kernels if key in e.key]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    kernel_ms = sum(e.self_device_time_total for e in hits) / 1e3
    return wall, (kernel_ms if total else None), sum(e.count for e in hits), total or None


def main(other_src: str) -> int:
    logs = _build.build_all()
    print("\n".join(f"ptxas: {line.strip()}" for line in logs["sojourn_static"].splitlines()
                    if any(key in line for key in ("Compiling entry", "registers", "spill"))))
    enum_other, mc_other, outcomes_other = other_kernels(other_src)
    ok = True
    j26 = generate_workload(np.random.default_rng(31), 26, 2)
    rng = np.random.default_rng(8)
    j8 = generate_workload(rng, 8, 3)
    shapes = (
        ("N=26 M=2 K=2^26 P=1 (RANK)", static_args(j26, policies.rank_order(j26)[None]), 3),
        ("N=8 M=3 K=3^8 P=512", static_args(j8, np.stack([rng.permutation(8)
                                                           for _ in range(512)])), 10),
    )
    for label, args, reps in shapes:
        got = K.sojourn_enum(*args)
        same = equal(got, K.sojourn_enum(*args))
        err_plain = rel(got, K.sojourn_enum_torch(*args))
        err_other = rel(got, enum_other(*args))
        ok &= same and err_plain <= RTOL and err_other <= RTOL
        mine = lambda: K.sojourn_enum(*args)  # noqa: E731
        theirs = lambda: enum_other(*args)  # noqa: E731
        fns = [mine, theirs, theirs, mine]
        for fn in fns:
            fn()  # warm up
        times = [median_ms(fn, reps) for fn in fns]
        p_orders, n, _ = args[0].shape
        print(f"sojourn_enum {label} (L={K.suffix_length(n, p_orders, args[-1])}): "
              f"e_succ[0] {got[0][0].item()!r}, second call equal {same}, rel err against the "
              f"plain version {err_plain:.3e} and the other kernel {err_other:.3e}; ms this, "
              f"other, other, this: " + ", ".join(f"{t:.4f}" for t in times), flush=True)

    # the other static kernels keep their bits
    j27 = generate_workload(np.random.default_rng(27), 27, 2)
    args = static_args(j27, policies.rank_order(j27)[None], (SEED, 1 << 23))
    same = equal(K.sojourn_mc(*args), mc_other(*args))
    ok &= same
    print(f"sojourn_mc N=27 S=2^23: bitwise equal to the other source's {same}")
    j21 = generate_workload(np.random.default_rng(21), 21, 2)
    outcomes, weights = evaluator.enumerate_outcomes(j21)
    tables = ops.outcome_tables(outcomes, weights, policies.padded_arrays(j21)[2],
                                torch.device("cuda"))
    args = ops.outcomes_kernel_args(policies.padded_arrays(j21)[0],
                                    policies.padded_arrays(j21)[2],
                                    policies.rank_order(j21)[None], tables, torch.device("cuda"))
    same = equal(K.sojourn_outcomes(*args), outcomes_other(*args))
    ok &= same
    print(f"sojourn_outcomes N=21 K=2^21 table: bitwise equal to the other source's {same}")

    # the N=8 OPTIMAL cell with each enumeration kernel, in turns
    runs = [("this", K.sojourn_enum, "enum_kernel"), ("other", enum_other, "static_kernel<false>")]
    for name, fn, key in runs + runs[::-1]:
        wall, kernel_ms, launches, device_ms = optimal_cell(fn, key)
        print(f"N=8 OPTIMAL cell, {name} kernel: host wall {wall:.4f} s; profiled run: "
              f"enumeration kernel {kernel_ms} ms over {launches} launches, all device time "
              f"{device_ms} ms", flush=True)
    print(torch.cuda.get_device_name(0))
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) != 2 or not os.path.exists(sys.argv[1]):
        sys.exit("usage: python -m repro_torch.kernels.sojourn_eval.compare_static "
                 "OTHER/sojourn_static.cu")
    sys.exit(main(sys.argv[1]))
