"""Work of ``sojourn_mc``: static orders by streamed Monte Carlo.

Frozen from the count that the kernel's roofline was first read with.
Float64 operations per sample and order: at each position M CDF compares,
the uniform's scaling and two completion-time adds, one add per success
(in expectation), and the six-operation tail of Eqs. (7)/(9).  Bytes:
each order's call reads its permuted sizes and CDF (float64) and stage
counts and job ids (int32) once and writes two float64 results.  The
stream: one Threefry block for each pair of job and sample, a launch.
"""

import numpy as np

from portbench.counts.threefry_stream import alu_ops


def work(probs, num_stages, n_orders: int, count: int) -> dict:
    probs = np.asarray(probs, dtype=np.float64)
    n, m = probs.shape
    p_succ = float(probs[np.arange(n), np.asarray(num_stages) - 1].sum())
    flops = n_orders * (count * ((m + 3) * n + 6) + count * p_succ)
    return {"flops": float(flops), "bytes": n_orders * (2 * n * m * 8 + 2 * n * 4 + 2 * 8),
            "stream": alu_ops(n, count)}
