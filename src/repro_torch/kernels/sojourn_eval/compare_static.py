"""Check and time this tree's static sojourn kernels on the card, in turns
with those built from another ``sojourn_static.cu`` whose launchers are
those of the first Monte-Carlo and outcome kernels (PR 21's source: the
enumeration takes the suffix length, ``sojourn_mc`` the float64 CDF and
``sojourn_outcomes`` a job-major (N, K) table):

    python -m repro_torch.kernels.sojourn_eval.compare_static OTHER/sojourn_static.cu

Prints this source's ptxas lines (registers, spills), checks that
``kernel.outcomes_smem_bytes`` counts the source's own layout
(``sojourn_outcomes_smem``) at a few plans, and, from ``cuobjdump -sass``
of both libraries, the instructions of each Monte-Carlo kernel's loop
that holds its Threefry blocks, by mnemonic and by pipe, per block (each
block's rotates are 19 ``SHF.L.W``), and of this outcome kernel's loop
per row and position (one ``DFMA`` each).  Holds this
enumeration kernel against the plain version and against the other
kernel, to 1e-12 relative, at N=26 K=2^26 P=1 (RANK) and at N=8 M=3
K=3^8 P=512 (a batch of the OPTIMAL search), with a second call bitwise
equal to the first; ``sojourn_mc`` bitwise equal to the other source's at
N=27 S=2^23 and N=80 S=2^20; ``sojourn_outcomes`` within 1e-12 of the
other source's at N=21 (the K=2^21 enumerated table, RANK) and at
phase 4's N=27 call (2^21 sampled rows, RANK and 16 RANDOM orders), each
source fed its own layout.  Times the kernels at those shapes in turns
(this, other, other, this; the median of calls timed one by one behind a
sleep on the card), and reads the SM clock while this ``sojourn_mc`` runs
back to back for a second; at the N=27 outcome call the other source
both as the parent's main path launched it (17 calls of one order) and
as one call of 17 orders.  Then ROADMAP's P5: the other source's kernels
past their shared-memory limits (N = 192 for the outcome kernel, 1228
and 1229 for MC, M = 2) and this tree's on both sides, against the plain
versions.  Last it drives the N=8 OPTIMAL cell of
``chip_smoke.py``'s phase 3 (``evaluate_many`` on the seed-8 group of 8
three-stage jobs, OPTIMAL, RANK, SERPT and SR) with each enumeration
kernel in turns: its host wall (results on the host) and, in one more run
under ``torch.profiler``, the enumeration kernel's time summed over its
launches and all device time.  Exits 1 if a check fails.  Needs a CUDA
card and ``nvcc``; the other library is built beside this tree's, in
``kernels/_build/``, against this tree's headers (``common.cuh``,
``threefry.cuh``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
#: Orders a block of the other source's outcome kernel evaluated.
OTHER_OUTCOMES_CHUNK = 8
#: SASS mnemonics by the SM pipe that runs them (Hopper).
PIPES = {
    "alu": ("LOP3", "LOP", "SHF", "SHL", "SHR", "IADD3", "ISETP", "SEL", "IMNMX", "VIMNMX",
            "PRMT", "LEA", "PLOP3", "FSEL", "MOV", "IABS", "POPC", "FLO", "BMSK", "BREV",
            "P2R", "R2P", "FSETP", "FMNMX", "CSET", "CSETP"),
    "fma/imad": ("IMAD", "FFMA", "FMUL", "FADD", "IMUL", "IDP", "HFMA2"),
    "fp64": ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX"),
    "conversion": ("I2F", "F2I", "F2F", "I2FP", "F2FP", "FRND", "MUFU"),
    "memory": ("LDS", "LDG", "LDC", "LDL", "STS", "STG", "STL", "LD", "ST", "ULDC", "ATOM",
               "RED", "SHFL"),
    "control": ("BRA", "EXIT", "BSSY", "BSYNC", "NOP", "WARPSYNC", "CALL", "RET", "YIELD",
                "BAR", "BPT", "JMP"),
}


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


def in_turns(label, mine, theirs, reps) -> list[float]:
    """Times of ``mine`` and ``theirs`` in turns (this, other, other, this)."""
    fns = [mine, theirs, theirs, mine]
    for fn in fns:
        fn()  # warm up
    times = [median_ms(fn, reps) for fn in fns]
    print(f"{label}: ms this, other, other, this: " + ", ".join(f"{t:.4f}" for t in times),
          flush=True)
    return times


def sustained_clock_mhz(fn, seconds: float = 1.0) -> list[float]:
    """SM clocks (MHz) that ``nvidia-smi`` reads every 20 ms while ``fn``
    runs back to back on the card for about ``seconds`` (the first fifth
    of the readings, the clock's ramp, left out)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    calls = max(1, int(seconds / max(time.perf_counter() - t0, 1e-6)))
    poll = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                             "-lms", "20"], stdout=subprocess.PIPE, text=True)
    try:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    finally:
        poll.terminate()
    readings = [float(v) for v in poll.communicate()[0].split()]
    return readings[len(readings) // 5:]


def pipe_of(op: str) -> str:
    base = op.split(".")[0]
    for pipe, names in PIPES.items():
        if base in names:
            return pipe
    return "other"


def unit_loops(lib: Path, kernel: str, marker: str, per_unit: int, min_units: int) -> dict:
    """``{function: (units, mnemonic counts)}`` of the innermost loop of each
    function of ``lib`` whose name holds ``kernel`` that holds at least
    ``min_units`` units of work, a unit counted as ``per_unit``
    instructions starting with ``marker``: the instructions from a backward
    branch's target to the branch, as ``cuobjdump -sass`` prints them."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split()[0]
        if kernel not in name or "dynamic" in name:
            continue
        code = []  # (address, mnemonic, branch target or None)
        for addr, ins in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", chunk):
            words = ins.split()
            if words and words[0].startswith("@"):
                words = words[1:]
            if not words:
                continue
            target = re.search(r"0x([0-9a-f]+)", ins) if words[0].startswith("BRA") else None
            code.append((int(addr, 16), words[0], int(target.group(1), 16) if target else None))
        best = None
        for lo, hi in ((t, a) for a, _, t in code if t is not None and t < a):
            body = [op for a, op, _ in code if lo <= a <= hi]
            marks = sum(op.startswith(marker) for op in body)
            if marks >= per_unit * min_units and (best is None or hi - lo < best[1] - best[0]):
                best = (lo, hi, marks, body)
        if best:
            out[name] = (round(best[2] / per_unit), collections.Counter(best[3]))
    return out


def print_sass(tag: str, lib: Path, kernel: str, marker: str, per_unit: int, min_units: int,
               unit: str) -> None:
    for name, (units, counts) in unit_loops(lib, kernel, marker, per_unit, min_units).items():
        by_pipe = collections.Counter()
        for op, c in counts.items():
            by_pipe[pipe_of(op)] += c
        per = ", ".join(f"{p} {c / units:.2f}" for p, c in sorted(by_pipe.items()))
        ops_ = ", ".join(f"{op} {c}" for op, c in counts.most_common())
        print(f"sass {tag} {name}: the loop holds {units} {unit}(s), "
              f"{sum(counts.values())} instructions; a {unit}: {per}; all: {ops_}", flush=True)


def other_kernels(src: str):
    """``(lib path, enum, mc, outcomes)`` launching the kernels built from
    ``src``, each with its wrapper's signature and grid; ``outcomes`` takes
    this tree's (K, N) table and hands the other kernel its transpose."""
    lib_path = _build.BUILD_DIR / "libsojourn_static-other.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", CSRC, "-o", str(lib_path),
                           src], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
    lib.sojourn_enum_launch.argtypes = [p, p, p, p, i, i, i, ll, i, i, p, p, p]
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
        suffix = K.suffix_length(n, p_orders, k_total)
        return run(lib.sojourn_enum_launch, p_orders, K.enum_prefixes(n, suffix, k_total),
                   (sizes_p.data_ptr(), probs_p.data_ptr(), strides_p.data_ptr(),
                    radix_p.data_ptr(), p_orders, n, m, k_total, suffix))

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
                   rows=-(-p_orders // OTHER_OUTCOMES_CHUNK))

    return lib_path, enum, mc, outcomes


def p5_case(label, kernel, plain, other, args, other_args) -> bool:
    """This tree's kernel within 1e-9 of the plain version, a second call
    bitwise equal; and whether the other source's kernel runs at all."""
    got = kernel(*args)
    err = rel(got, plain(*args))
    same = equal(got, kernel(*args))
    try:
        other(*other_args)
        torch.cuda.synchronize()
        theirs = "runs"
    except RuntimeError as exc:
        theirs = f"fails: {exc}"
    print(f"P5 {label}: this kernel rel err {err:.3e} against the plain version, second call "
          f"equal {same}; the other source's kernel {theirs}", flush=True)
    return err <= 1e-9 and same


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
    other_lib, enum_other, mc_other, outcomes_other = other_kernels(other_src)
    mine = _build.library("sojourn_static", K._SIGNATURES)
    mine.sojourn_outcomes_smem.argtypes = [ctypes.c_int] * 6
    mine.sojourn_outcomes_smem.restype = ctypes.c_longlong
    ok = True
    for n, m, p_orders in ((21, 2, 1), (27, 2, 17), (16, 4, 40), (192, 2, 40), (1, 3, 9)):
        plan = K.outcomes_plan(n, m, p_orders)
        args = (n, m, plan.rows, plan.stages, plan.group, plan.split)
        same = mine.sojourn_outcomes_smem(*args) == K.outcomes_smem_bytes(*args)
        ok &= same
        print(f"outcome kernel plan N={n} M={m} P={p_orders}: {plan}, shared bytes "
              f"{K.outcomes_smem_bytes(*args)}, the source's count equal {same}")
    mine_lib = _build._target("sojourn_static", _build._digest("sojourn_eval"))
    for tag, lib in (("this", mine_lib), ("other", other_lib)):
        # each Threefry block rotates 19 times
        print_sass(tag, lib, "mc_kernel", "SHF.L.W", 19, 1, "Threefry block")
    # this outcome kernel adds a success with one fma a row and position; its
    # main loop serves 4 positions of 2 rows
    print_sass("this", mine_lib, "outcomes_kernel", "DFMA", 1, 8, "row and position")
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
        p_orders, n, _ = args[0].shape
        print(f"sojourn_enum {label} (L={K.suffix_length(n, p_orders, args[-1])}): "
              f"e_succ[0] {got[0][0].item()!r}, second call equal {same}, rel err against the "
              f"plain version {err_plain:.3e} and the other kernel {err_other:.3e}", flush=True)
        in_turns(f"sojourn_enum {label}", functools.partial(K.sojourn_enum, *args),
                 functools.partial(enum_other, *args), reps)

    # sojourn_mc: bitwise the other source's at the main path's shapes
    j27 = generate_workload(np.random.default_rng(27), 27, 2)
    j80 = generate_workload(np.random.default_rng(80), 80, 2)
    for label, jobs, samples in (("N=27 M=2 S=2^23 P=1 (RANK)", j27, 1 << 23),
                                 ("N=80 M=2 S=2^20 P=1 (RANK)", j80, 1 << 20)):
        args = static_args(jobs, policies.rank_order(jobs)[None], (SEED, samples))
        got = K.sojourn_mc(*args)
        same = equal(got, mc_other(*args)) and equal(got, K.sojourn_mc(*args))
        ok &= same
        print(f"sojourn_mc {label}: e_succ {got[0][0].item()!r}, bitwise equal to the other "
              f"source's and to a second call {same}", flush=True)
        in_turns(f"sojourn_mc {label}", functools.partial(K.sojourn_mc, *args),
                 functools.partial(mc_other, *args), 3)
        clocks = sustained_clock_mhz(functools.partial(K.sojourn_mc, *args))
        if clocks:
            print(f"sojourn_mc {label}, this kernel back to back: SM clock {min(clocks):.0f}-"
                  f"{max(clocks):.0f} MHz, median {statistics.median(clocks):.0f} "
                  f"({len(clocks)} readings)", flush=True)

    # sojourn_outcomes at phase 4's tables: each source its own layout
    rng = np.random.default_rng(21)
    j21 = generate_workload(rng, 21)
    j27 = generate_workload(rng, 27)
    table21 = evaluator.enumerate_outcomes(j21)
    table27 = evaluator.sample_outcomes(j27, 1 << 21, rng)
    orders27 = np.stack([policies.rank_order(j27)]
                        + [policies.random_order(j27, rng) for _ in range(16)])
    for label, jobs, (outcomes, weights), orders in (
            ("N=21 M=2 K=2^21 enumerated table, P=1 (RANK)", j21, table21,
             policies.rank_order(j21)[None]),
            ("N=27 M=2 S=2^21 sampled table, P=17 (RANK, 16 RANDOM)", j27, table27, orders27)):
        sizes, _, num_stages = policies.padded_arrays(jobs)
        dev = torch.device("cuda")
        args = ops.outcomes_kernel_args(sizes, num_stages, orders,
                                        ops.outcome_tables(outcomes, weights, num_stages, dev),
                                        dev)
        other_args = (*args[:3], args[3].T.contiguous(), args[4])
        got = K.sojourn_outcomes(*args)
        same = equal(got, K.sojourn_outcomes(*args))
        err_other = rel(got, outcomes_other(*other_args))
        ok &= same and err_other <= RTOL
        print(f"sojourn_outcomes {label}: e_succ[0] {got[0][0].item()!r}, second call equal "
              f"{same}, rel err against the other source {err_other:.3e}", flush=True)
        mine = functools.partial(K.sojourn_outcomes, *args)
        in_turns(f"sojourn_outcomes {label}", mine,
                 functools.partial(outcomes_other, *other_args), 10)
        if len(orders) > 1:  # the parent's main path: one launch an order
            one = [functools.partial(outcomes_other, args[0][i:i + 1], args[1][i:i + 1],
                                     args[2][i:i + 1], *other_args[3:])
                   for i in range(len(orders))]
            in_turns(f"sojourn_outcomes {label}, the other source one order a call", mine,
                     lambda: [fn() for fn in one], 10)  # noqa: B023

    # P5: the other source's kernels past their shared-memory limits (64 N M +
    # 64 N + 1024 N bytes for the outcome kernel, 16 N M + 8 N for MC), and
    # this tree's on both sides of them against the plain versions
    for n in (191, 192):
        jobs = generate_workload(np.random.default_rng(n), n, 2)
        rng = np.random.default_rng(n)
        outcomes, weights = evaluator.sample_outcomes(jobs, 3000, rng)
        orders = np.stack([policies.rank_order(jobs)] + [rng.permutation(n) for _ in range(2)])
        sizes, _, num_stages = policies.padded_arrays(jobs)
        dev = torch.device("cuda")
        args = ops.outcomes_kernel_args(sizes, num_stages, orders,
                                        ops.outcome_tables(outcomes, weights, num_stages, dev),
                                        dev)
        ok &= p5_case(f"sojourn_outcomes N={n} M=2 K=3000 P=3", K.sojourn_outcomes,
                      K.sojourn_outcomes_torch, outcomes_other, args,
                      (*args[:3], args[3].T.contiguous(), args[4]))
    for n in (1228, 1229):
        jobs = generate_workload(np.random.default_rng(n), n, 2)
        args = static_args(jobs, policies.rank_order(jobs)[None], (SEED, 1 << 12))
        ok &= p5_case(f"sojourn_mc N={n} M=2 S=2^12 P=1", K.sojourn_mc, K.sojourn_mc_torch,
                      mc_other, args, args)

    # the N=8 OPTIMAL cell with each enumeration kernel, in turns
    runs = [("this", K.sojourn_enum, "enum_kernel"), ("other", enum_other, "enum_kernel")]
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
