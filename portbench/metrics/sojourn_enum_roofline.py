"""Share of its bound of ``sojourn_enum`` (``csrc/sojourn_static.cu``), the
exact evaluation of static orders, in %: the least time of the work the
window's groups needed of it (``counts/sojourn_enum.py``, at the peaks of
``harness/peaks.py``) over the device time of its kernels and their
``reduce_partials`` tails in the trace. Nothing to read when the trace holds
no such kernel."""

from portbench.harness.work import roofline_pct

KERNEL = "sojourn_enum"
PATTERN = r"\benum_kernel<"


def read(window):
    return roofline_pct(window, KERNEL, PATTERN)
