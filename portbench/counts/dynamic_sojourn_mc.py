"""Work of ``dynamic_sojourn_mc``: stage-level index policies on one
server by streamed Monte Carlo.

Frozen from the count that the kernel's roofline was first read with.
Float64 operations per sample and policy: the decode (per job its M_i - 1
CDF compares and the uniform's scaling), one clock add per seat (in
expectation ``sum_i sum_s (s + 1) p_is``), one completion add a job, one
add per success (in expectation) and the six-operation tail; the index
compares are not counted, so the bound is a lower one.  Bytes: a
policy's call reads the CDF and stage durations (float64, (N, M)), its
index table (float64, (N, M)) and the stage counts (int32) once and writes
two float64 results.  The stream: one Threefry block for each pair of job
and sample, a launch.
"""

import numpy as np

from portbench.counts.threefry_stream import alu_ops


def work(probs, num_stages, n_pols: int, count: int) -> dict:
    probs = np.asarray(probs, dtype=np.float64)
    num_stages = np.asarray(num_stages)
    n, m = probs.shape
    p_succ = probs[np.arange(n), num_stages - 1]
    decode = float(num_stages.sum())
    seats = count * sum(float((np.arange(r) + 1) @ probs[i, :r])
                        for i, r in enumerate(num_stages))
    flops = n_pols * (count * (decode + n + 6) + seats + count * float(p_succ.sum()))
    return {"flops": float(flops), "bytes": n_pols * (3 * n * m * 8 + n * 4 + 2 * 8),
            "stream": alu_ops(n, count)}
