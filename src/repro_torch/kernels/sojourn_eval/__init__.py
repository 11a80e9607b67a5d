"""Fused evaluator of E[sojourn time of successful jobs] (paper Eqs. 7-9).

The port of ``repro/kernels/sojourn_eval``.  Four CUDA kernels replace
the TPU kernels on the evaluator's main path:

* ``kernel.sojourn_enum`` / ``kernel.sojourn_mc`` — static orders, exact
  enumeration and streamed Monte Carlo (``csrc/sojourn_static.cu``);
* ``dynamic.dynamic_sojourn_enum`` / ``dynamic.dynamic_sojourn_mc`` —
  stage-level index policies on W servers (``csrc/sojourn_dynamic.cu``).

``ops.sojourn_eval`` and ``dynamic.sojourn_eval_dynamic`` front them on
NumPy workload arrays; ``_build`` compiles ``csrc/`` with ``nvcc`` at
first use.  Each wrapper has a plain PyTorch version beside it, which
runs for CPU tensors and is what the kernels are checked against.
"""

from repro_torch.kernels.sojourn_eval.dynamic import sojourn_eval_dynamic  # noqa: F401
from repro_torch.kernels.sojourn_eval.ops import sojourn_eval  # noqa: F401
