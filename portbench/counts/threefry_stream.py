"""ALU-only integer operations of the Threefry stream that a streamed
evaluation needs: one Threefry-2x32 block for each pair of job and sample
(x0 = sample, x1 = original job id; the .x word).  A block takes 20 adds,
19 rotates, 19 xors and 9 key injections for the .x word, 38 of them on
the ALU pipe alone (rotates and xors).  Every order and policy sees the
same stream, so it is counted once a launch, whatever that launch serves."""

THREEFRY_ALU_OPS = 38


def alu_ops(n_jobs: int, n_samples: int) -> float:
    return float(THREEFRY_ALU_OPS) * n_jobs * n_samples
