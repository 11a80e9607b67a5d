"""PyTorch/CUDA port of :mod:`repro`: E[sojourn time of successful jobs].

The package mirrors ``repro``'s layout and names (``repro_torch/core/
evaluator.py`` is the counterpart of ``repro/core/evaluator.py``) and
imports neither JAX nor anything of ``repro``.  Its entry points take
``device=None``, which means the CUDA card; ``device="cpu"`` runs the
plain PyTorch versions of the kernels instead (see
:mod:`repro_torch.device`).  The fused evaluator's four kernels are CUDA
C++ for ``sm_90a`` under ``kernels/sojourn_eval/csrc/``, built with
``nvcc`` at first use.
"""

from repro_torch.device import resolve_device  # noqa: F401
