"""The H100's peaks that the work counts are held against.

NVIDIA's data sheet for the H100 SXM at its full 700 W: float64 at 34
TFLOP/s (vector rate) and HBM at 3.35 TB/s.  The Threefry stream's
rotates and xors run only on the ALU pipe: 64 lanes an SM on 132 SMs at
the card's own maximum SM clock, read from ``nvidia-smi``.  A card set
below 700 W runs slower under load, so its power limit is recorded beside
every share.
"""

from __future__ import annotations

import dataclasses
import subprocess

FP64_FLOPS = 34e12
HBM_BYTES_PER_S = 3.35e12
ALU_LANES_PER_SM = 64
SM_COUNT = 132


@dataclasses.dataclass(frozen=True)
class Peaks:
    fp64: float
    hbm: float
    alu: float  # ALU-only integer operations a second
    max_sm_clock_mhz: float
    power_limit_w: float | None

    def least_seconds(self, flops: float, nbytes: float, stream: float) -> float:
        """The least time of that work on the card: the largest of its float64
        operations, its stream's integer operations and its bytes at peak."""
        return max(flops / self.fp64, stream / self.alu, nbytes / self.hbm)


def query(gpu: int = 0) -> Peaks:
    """The peaks of card ``gpu``, with its maximum SM clock and power limit."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(gpu), "--query-gpu=clocks.max.sm,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    clock, power = (f.strip() for f in out.strip().splitlines()[0].split(","))
    mhz = float(clock)
    try:
        watts = float(power)
    except ValueError:  # "[N/A]"
        watts = None
    return Peaks(FP64_FLOPS, HBM_BYTES_PER_S, ALU_LANES_PER_SM * SM_COUNT * mhz * 1e6, mhz,
                 watts)
