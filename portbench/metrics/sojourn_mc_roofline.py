"""Share of its bound of ``sojourn_mc`` (``csrc/sojourn_static.cu``), static
orders by streamed Monte Carlo, in %: the least time of the work the
window's groups needed of it (``counts/sojourn_mc.py``, at the peaks of
``harness/peaks.py``) over the device time of its kernels and their
``reduce_partials`` tails in the trace. Nothing to read when the trace holds
no such kernel."""

from portbench.harness.work import roofline_pct

KERNEL = "sojourn_mc"
PATTERN = r"\bmc_kernel<"


def read(window):
    return roofline_pct(window, KERNEL, PATTERN)
