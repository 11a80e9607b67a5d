"""Share of its bound of ``dynamic_sojourn_enum``
(``csrc/sojourn_dynamic.cu``), the exact evaluation of stage-level index
policies, in %: the least time of the work the window's groups needed of it
(``counts/dynamic_sojourn_enum.py``, at the peaks of ``harness/peaks.py``)
over the device time of its kernels and their ``reduce_partials`` tails in
the trace. Nothing to read when the trace holds no such kernel."""

from portbench.harness.work import roofline_pct

KERNEL = "dynamic_sojourn_enum"
PATTERN = r"\bdynamic_kernel(_mem)?<false\b"


def read(window):
    return roofline_pct(window, KERNEL, PATTERN)
