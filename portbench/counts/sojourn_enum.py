"""Work of ``sojourn_enum``: the exact evaluation of static orders.

Frozen from the count that the kernel's roofline was first read with.
Float64 operations: a walk that shares service-order prefixes serves
position q once for each distinct prefix through q, ``prod_{i <= q}
M_(i)`` times (the weight product and two completion-time adds), adds the
success for each prefix that ends in one at q, ``prod_{i < q} M_(i)`` of
them, and gives each of the K combinations the six-operation tail of Eqs.
(7)/(9).  Every job of a group has the same M here, so the service order
does not change the count.  Bytes: each order's call reads its permuted
sizes and probabilities (float64) and strides and stage counts (int32)
once and writes two float64 results.  No random stream.
"""

import numpy as np


def work(probs, num_stages, n_orders: int, count: int) -> dict:
    n, m = np.shape(probs)
    stages = np.broadcast_to(np.asarray(num_stages, dtype=np.float64), (n_orders, n))
    prefixes = np.cumprod(stages, axis=1)
    successes = prefixes / stages
    flops = float(3.0 * prefixes.sum() + successes.sum() + 6.0 * count * n_orders)
    return {"flops": flops, "bytes": n_orders * (2 * n * m * 8 + 2 * n * 4 + 2 * 8),
            "stream": 0.0}
