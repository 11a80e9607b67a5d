"""Work of ``dynamic_sojourn_enum``: the exact evaluation of stage-level
index policies on one server.

Frozen from the count that the kernel's roofline was first read with.
Float64 operations per combination and policy: the decode's N weight
products, one clock add per seat (job i runs s_i + 1 stages: over the K
combinations, K (M_i + 1) / 2 seats a job), one completion add a job, one
add per success (each stop stage of job i lies in K / M_i combinations)
and the six-operation tail.  The index compares among queued jobs are
not counted (their number depends on the data and on how the queue is
kept), nor integer operations and selects, so the bound is a lower one.
Bytes: a policy's call reads the probabilities and stage durations
(float64, (N, M)), its index table (float64, (N, M)) and strides and stage
counts (int32) once and writes two float64 results.  No random stream.
"""

import numpy as np


def work(probs, num_stages, n_pols: int, count: int) -> dict:
    n, m = np.shape(probs)
    num_stages = np.asarray(num_stages)
    seats = count * float((num_stages + 1).sum()) / 2
    succ_adds = float(sum(count // int(r) for r in num_stages))
    flops = n_pols * (count * (n + n + 6) + seats + succ_adds)
    return {"flops": float(flops), "bytes": n_pols * (3 * n * m * 8 + 2 * n * 4 + 2 * 8),
            "stream": 0.0}
