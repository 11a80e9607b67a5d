#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card (the first
run builds the kernels from ``src/repro_torch/kernels/sojourn_eval/csrc``
with ``nvcc``):

    python3 chip_smoke.py

Phases, each of which must pass:

0. build every kernel with ``nvcc`` and print its registers and spills;
1. hold each of the four kernels against its plain PyTorch version on the
   card, at mid sizes, to a relative error of at most 1e-9;
2. replay the paper's worked example (SR 10, SERPT 9.75, OPTIMAL 9.1 with
   order [0, 1], RANK 9.1) through the default-device entry points;
3. drive the main path at full size, through the kernels only:
   ``evaluate_many`` at N=26 (K = 2**26, the exact cap), at N=8, M=3 with
   OPTIMAL (8! orders x 3**8 combinations) and at N=27 (K = 2**27, streamed
   with 2**23 samples).  The launch counts are set to 0 just before and
   read just after; every kernel must have launched.  Then a constant
   index table through the dynamic kernel must give the static RANK
   order's value at N=26;
4. time each kernel and its plain version with CUDA events at the
   largest phase-3 shapes (and hold the two results against each other
   there too), and reckon the kernel's bound.  Phase 1 times both at its
   mid sizes as well.

It prints the kernel report as one JSON line, the card's name and power
limit from ``nvidia-smi``, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA, or when a phase fails, it exits non-zero and prints no
result.  It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
RTOL = 1e-9
#: H100 SXM published peaks (NVIDIA data sheet): float64 vector rate and
#: HBM bandwidth, at the full 700 W power limit.
FP64_FLOPS = 34e12
HBM_BYTES_PER_S = 3.35e12
KERNEL_SOURCE = "src/repro_torch/kernels/sojourn_eval/csrc/"
REPLACES = {
    "sojourn_enum": "src/repro/kernels/sojourn_eval/kernel.py:162",
    "sojourn_mc": "src/repro/kernels/sojourn_eval/kernel.py:367",
    "dynamic_sojourn_enum": "src/repro/kernels/sojourn_eval/dynamic.py:351",
    "dynamic_sojourn_mc": "src/repro/kernels/sojourn_eval/dynamic.py:410",
}
SOURCES = {
    "sojourn_enum": "sojourn_static.cu",
    "sojourn_mc": "sojourn_static.cu",
    "dynamic_sojourn_enum": "sojourn_dynamic.cu",
    "dynamic_sojourn_mc": "sojourn_dynamic.cu",
}
SEED = 0x5EED_CAFE


class PhaseFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailure(msg)


def rel_err(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))


def abs_err(got, want) -> float:
    import numpy as np

    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def cuda_ms(fn, reps: int):
    """(mean milliseconds of ``fn()`` on the card over ``reps`` runs, timed
    with CUDA events; the last run's result)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def check_against_plain(report, name, shape, got, want) -> None:
    """Hold a kernel's (e_succ, e_all) against its plain version's."""
    import numpy as np

    got = [t.cpu().numpy() for t in got]
    want = [t.cpu().numpy() for t in want]
    require(all(np.all(np.isfinite(g)) for g in got), f"{name} {shape}: non-finite output")
    rel = max(rel_err(g, w) for g, w in zip(got, want))
    err = max(abs_err(g, w) for g, w in zip(got, want))
    r = report.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["max_rel_err"] = max(r["max_rel_err"], rel)
    log(f"[kernel vs plain] {name} {shape}: e_succ[:3]={got[0][:3]} max rel err {rel:.3e} "
        f"abs {err:.3e}")
    require(rel <= RTOL, f"{name} {shape}: rel err {rel:.3e} > {RTOL}")


# ---------------------------------------------------------------------------
# Kernel inputs from a workload, as the ops build them
# ---------------------------------------------------------------------------


def static_args(jobs, orders, dev, samples=None):
    from repro_torch.core import policies
    from repro_torch.kernels.sojourn_eval import ops

    return ops.static_kernel_args(*policies.padded_arrays(jobs), orders, dev, samples)


def dynamic_args(jobs, tables, dev, samples=None):
    import numpy as np

    from repro_torch.core import policies
    from repro_torch.kernels.sojourn_eval import dynamic as D

    _, probs, num_stages = policies.padded_arrays(jobs)
    return D.dynamic_kernel_args(probs, policies.stage_durations(jobs), num_stages,
                                 np.stack(tables), dev, samples)


# ---------------------------------------------------------------------------
# Bounds: float64 operations per lane x lanes over the float64 peak
# ---------------------------------------------------------------------------


def static_flops(jobs, n_orders: int, count: int, mc: bool) -> float:
    """Float64 operations of the static kernel.  Per position: the weight
    product (enum) or M CDF compares and the uniform's scaling (MC), and
    the two completion-time adds; per success one add; per lane the
    Eq. (7)/(9) tail (two divides, two products, two sums).  Integer
    div/mod, Threefry's uint32 arithmetic and selects are not counted.
    Success adds are exact for the enumeration and their expectation
    for MC."""
    import numpy as np

    from repro_torch.core import policies

    _, probs, num_stages = policies.padded_arrays(jobs)
    n, m = probs.shape
    p_succ = probs[np.arange(n), num_stages - 1]
    per_pos = (m + 3) if mc else 3
    succ_adds = count * float(p_succ.sum()) if mc else float(sum(count // r for r in num_stages))
    return n_orders * (count * (per_pos * n + 6) + succ_adds)


def dynamic_flops(jobs, n_pols: int, count: int, mc: bool) -> float:
    """Float64 operations the dynamic function needs on one server (the
    timed runs), per lane: the decode (N weight products, or per job its
    M_i - 1 CDF compares and the uniform's scaling), one clock add per
    seat (job i runs s_i + 1 stages, so sum_i (s_i + 1) seats), one
    completion add per job, one add per success and the six-operation
    tail.  On one server the finished job is the one running, so a pop
    needs no compare.  Seats and successes are exact for the enumeration
    (each stop stage of job i lies in K / M_i combinations) and their
    expectation for MC.  The index compares among queued jobs are not
    counted (their number depends on the data and on how the queue is
    kept), nor are integer ops and selects, so the bound is a lower one."""
    import numpy as np

    from repro_torch.core import policies

    _, probs, num_stages = policies.padded_arrays(jobs)
    n = len(num_stages)
    p_succ = probs[np.arange(n), num_stages - 1]
    if mc:
        decode = float(num_stages.sum())
        seats = count * sum(float((np.arange(r) + 1) @ probs[i, :r])
                            for i, r in enumerate(num_stages))
        succ_adds = count * float(p_succ.sum())
    else:
        decode = float(n)
        seats = count * float((num_stages + 1).sum()) / 2
        succ_adds = float(sum(count // r for r in num_stages))
    return n_pols * (count * (decode + n + 6) + seats + succ_adds)


def bound_ms(flops: float, in_bytes: int, out_bytes: int) -> tuple[float, str]:
    t_ops = flops / FP64_FLOPS * 1e3
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def tensor_bytes(args) -> int:
    import torch

    return sum(a.numel() * a.element_size() for a in args if isinstance(a, torch.Tensor))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_build() -> None:
    from repro_torch.kernels.sojourn_eval import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(logs)} libraries in {time.perf_counter() - t0:.1f} s "
        f"({_build.BUILD_DIR})")
    for stem, out in logs.items():
        for line in out.splitlines():
            if "Compiling entry function" in line or "registers" in line or "spill" in line:
                log(f"  {stem}: {line.strip()}")


def phase_kernels(dev, report) -> None:
    """Phase 1: every kernel against its plain version on the card, at mid
    sizes and at the N=8, M=3 shapes of the OPTIMAL cell."""
    import numpy as np

    from repro_torch.core import policies
    from repro_torch.core.jobs import generate_workload
    from repro_torch.kernels.sojourn_eval import dynamic as D
    from repro_torch.kernels.sojourn_eval import kernel as K

    def compare(name, shape, kernel, plain, args, kwargs=None, time_it=False):
        kwargs = kwargs or {}
        label = f"{shape} {kwargs}" if kwargs else shape
        check_against_plain(report, name, label, kernel(*args, **kwargs),
                            plain(*args, **kwargs))
        if time_it:
            r = report[name]
            r["phase1_shape"] = shape
            r["phase1_ms"], _ = cuda_ms(lambda: kernel(*args, **kwargs), 3)
            r["phase1_plain_ms"], _ = cuda_ms(lambda: plain(*args, **kwargs), 1)
            log(f"  kernel {r['phase1_ms']:.3f} ms, plain {r['phase1_plain_ms']:.3f} ms")

    rng = np.random.default_rng(20)
    jobs = generate_workload(rng, 20)
    rank = policies.rank_order(jobs)
    orders = np.stack([rank, rank[::-1], rng.permutation(20)])
    compare("sojourn_enum", "N=20 M=2 K=2^20 P=3", K.sojourn_enum,
            K.sojourn_enum_torch, static_args(jobs, orders, dev), time_it=True)
    compare("sojourn_mc", "N=20 M=2 S=2^20 P=3", K.sojourn_mc, K.sojourn_mc_torch,
            static_args(jobs, orders, dev, (SEED, 1 << 20)), time_it=True)

    jobs = generate_workload(np.random.default_rng(16), 16)
    tables = [policies.index_table(jobs, "sr"), policies.index_table(jobs, "serpt")]
    for w in (1, 2, 3):
        compare("dynamic_sojourn_enum", "N=16 M=2 K=2^16 P=2 (SR, SERPT)",
                D.dynamic_sojourn_enum, D.dynamic_sojourn_enum_torch,
                dynamic_args(jobs, tables, dev), {"n_servers": w},
                time_it=w == 1)
    for w in (1, 2, 3):
        compare("dynamic_sojourn_mc", "N=16 M=2 S=2^18 P=2 (SR, SERPT)",
                D.dynamic_sojourn_mc, D.dynamic_sojourn_mc_torch,
                dynamic_args(jobs, tables, dev, (SEED, 1 << 18)),
                {"n_servers": w}, time_it=w == 1)

    # the OPTIMAL cell's shapes: 512-order batches of 8 jobs x 3 stages
    rng = np.random.default_rng(8)
    jobs = generate_workload(rng, 8, 3)
    orders = np.stack([rng.permutation(8) for _ in range(512)])
    compare("sojourn_enum", "N=8 M=3 K=3^8 P=512", K.sojourn_enum, K.sojourn_enum_torch,
            static_args(jobs, orders, dev))
    tables = [policies.index_table(jobs, "sr"), policies.index_table(jobs, "serpt")]
    compare("dynamic_sojourn_enum", "N=8 M=3 K=3^8 P=2 (SR, SERPT)",
            D.dynamic_sojourn_enum, D.dynamic_sojourn_enum_torch,
            dynamic_args(jobs, tables, dev))


def phase_worked_example() -> None:
    """Phase 2: paper Section III-A through the default-device entry points."""
    import numpy as np

    from repro_torch.core import evaluator
    from repro_torch.core.jobs import JobSpec

    jobs = [
        JobSpec(sizes=np.array([1.0, 10.0]), probs=np.array([0.25, 0.75]), job_id=0),
        JobSpec(sizes=np.array([3.0, 6.0]), probs=np.array([0.6, 0.4]), job_id=1),
    ]
    sr = evaluator.evaluate(jobs, "sr")
    serpt = evaluator.evaluate(jobs, "serpt")
    order, opt = evaluator.optimal_order(jobs)
    rank = evaluator.evaluate(jobs, "rank")
    log(f"[worked example] SR={sr!r} SERPT={serpt!r} OPTIMAL={opt!r} order={order.tolist()} "
        f"RANK={rank!r}")
    for name, got, want in (("SR", sr, 10.0), ("SERPT", serpt, 9.75),
                            ("OPTIMAL", opt, 9.1), ("RANK", rank, 9.1)):
        require(rel_err(got, want) <= RTOL, f"worked example {name}={got!r}, paper {want}")
    require(order.tolist() == [0, 1], f"worked example OPTIMAL order {order.tolist()}")


def phase_main_path() -> dict:
    """Phase 3: the full-size main path, with the launch counts around it."""
    import numpy as np

    from repro_torch.core import evaluator
    from repro_torch.core.jobs import generate_workload
    from repro_torch.kernels.sojourn_eval import dynamic as D
    from repro_torch.kernels.sojourn_eval import kernel as K

    cells = [
        ("N=26 M=2 exact (K=2^26)", 31, 26, 2, ("rank", "serpt", "sr", "random"), 4096),
        ("N=8 M=3 exact with OPTIMAL (8! orders x 3^8)", 8, 8, 3,
         ("optimal", "rank", "serpt", "sr"), 4096),
        ("N=27 M=2 streamed MC (K=2^27, S=2^23)", 27, 27, 2,
         ("rank", "serpt", "sr", "random"), 1 << 23),
    ]
    workloads = {}
    for name in K.launches:
        K.launches[name] = 0
    for name in D.launches:
        D.launches[name] = 0
    results = []
    for label, seed, n, m, algs, mc_samples in cells:
        rng = np.random.default_rng(seed)
        jobs = generate_workload(rng, n, m)
        workloads[n] = jobs
        t0 = time.perf_counter()
        res = evaluator.evaluate_many(jobs, algs, rng, mc_samples=mc_samples)
        secs = time.perf_counter() - t0
        results.append((label, res))
        log(f"[main path] {label}: {res} in {secs:.3f} s (host clock, results on host)")
    counts = {**K.launches, **D.launches}
    log(f"[main path] launches: {counts}")
    for label, res in results:
        for alg, v in res.items():
            require(math.isfinite(v) and v > 0, f"{label}: {alg}={v!r}")
    opt = results[1][1]
    require(opt["optimal"] <= opt["rank"] * (1 + RTOL),
            f"OPTIMAL {opt['optimal']!r} above RANK {opt['rank']!r}")
    for name, c in counts.items():
        require(c > 0, f"kernel {name} was not launched on the main path")
    return {"launches": counts, "workloads": workloads}


def phase_cross_check(jobs) -> None:
    """Phase 3b: a constant index table (rank values broadcast along M) on
    one server is the static RANK order, at N=26 through both kernels."""
    import numpy as np

    from repro_torch.core import policies
    from repro_torch.kernels.sojourn_eval import sojourn_eval, sojourn_eval_dynamic

    sizes, probs, num_stages = policies.padded_arrays(jobs)
    table = np.broadcast_to(policies.rank_values(jobs)[:, None], probs.shape)
    dyn = sojourn_eval_dynamic(probs, policies.stage_durations(jobs), num_stages, table)
    stat = sojourn_eval(sizes, probs, num_stages, policies.rank_order(jobs)[None])
    rel = max(rel_err(dyn[0], stat[0]), rel_err(dyn[1], stat[1]))
    log(f"[cross-check] N=26 constant-index dynamic {dyn[0][0]!r} vs static RANK "
        f"{stat[0][0]!r}: max rel err {rel:.3e}")
    require(rel <= RTOL, f"constant-index dynamic != static RANK: rel {rel:.3e}")


def phase_timing(dev, workloads, report) -> None:
    """Phase 4: each kernel and its plain version at the largest phase-3
    shapes, the kernel's last timed result held against the plain one;
    then the bound."""
    from repro_torch.core import policies
    from repro_torch.kernels.sojourn_eval import dynamic as D
    from repro_torch.kernels.sojourn_eval import kernel as K

    j26, j27 = workloads[26], workloads[27]
    s = 1 << 23
    cases = [
        ("sojourn_enum", "N=26 M=2 K=2^26 P=1 (RANK)", K.sojourn_enum, K.sojourn_enum_torch,
         static_args(j26, policies.rank_order(j26)[None], dev), 3,
         static_flops(j26, 1, 1 << 26, mc=False)),
        ("sojourn_mc", "N=27 M=2 S=2^23 P=1 (RANK)", K.sojourn_mc, K.sojourn_mc_torch,
         static_args(j27, policies.rank_order(j27)[None], dev, (SEED, s)), 3,
         static_flops(j27, 1, s, mc=True)),
        # one run: the K=2^26 dynamic enumeration is the slowest kernel call
        ("dynamic_sojourn_enum", "N=26 M=2 K=2^26 P=1 (SR) W=1", D.dynamic_sojourn_enum,
         D.dynamic_sojourn_enum_torch,
         dynamic_args(j26, [policies.index_table(j26, "sr")], dev), 1,
         dynamic_flops(j26, 1, 1 << 26, mc=False)),
        ("dynamic_sojourn_mc", "N=27 M=2 S=2^23 P=1 (SR) W=1", D.dynamic_sojourn_mc,
         D.dynamic_sojourn_mc_torch,
         dynamic_args(j27, [policies.index_table(j27, "sr")], dev, (SEED, s)), 3,
         dynamic_flops(j27, 1, s, mc=True)),
    ]
    for name, shape, fn, plain, args, reps, flops in cases:
        ms, got = cuda_ms(lambda: fn(*args), reps)
        plain_ms, want = cuda_ms(lambda: plain(*args), 1)
        check_against_plain(report, name, shape, got, want)
        b_ms, b_by = bound_ms(flops, tensor_bytes(args), 2 * 8)
        report[name].update(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, reps=reps)
        log(f"[timing] {name} {shape}: {ms:.3f} ms over {reps} run(s), plain {plain_ms:.1f} ms; "
            f"bound {b_ms:.4f} ms ({b_by}, {flops:.4g} float64 ops): {b_ms / ms:.2%} of it")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.device import resolve_device

    dev = resolve_device()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()
    report: dict[str, dict] = {}
    phase_build()
    phase_kernels(dev, report)
    phase_worked_example()
    main_path = phase_main_path()
    phase_cross_check(main_path["workloads"][26])
    phase_timing(dev, main_path["workloads"], report)
    smi = nvidia_smi()
    kernels = []
    for name in REPLACES:
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE + SOURCES[name],
            "replaces": REPLACES[name], "launches": main_path["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "max_rel_err": r["max_rel_err"], "shape": r["shape"],
            "phase1_shape": r["phase1_shape"], "phase1_ms": r["phase1_ms"],
            "phase1_plain_ms": r["phase1_plain_ms"],
        })
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
