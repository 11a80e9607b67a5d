"""PyTorch/CUDA port of :mod:`repro`: E[sojourn time of successful jobs].

The package mirrors ``repro``'s layout and names (``repro_torch/core/
evaluator.py`` is the counterpart of ``repro/core/evaluator.py``) and
imports neither JAX nor anything of ``repro``.  Its entry points take
``device=None``, which means the CUDA card; ``device="cpu"`` runs the
plain PyTorch versions of the kernels instead (see
:mod:`repro_torch.device`).  The kernels are CUDA C++ for ``sm_90a``
under ``kernels/<package>/csrc/`` (the fused evaluator's five in
``sojourn_eval``, the attention forward and backward in
``flash_attention``, the SSD scan in ``ssd_scan``, the expert FFN in
``moe_gemm``), built with ``nvcc`` at first use.  Beside the evaluator, ``models/`` and
``launch/serve.py`` serve the dense, moe and ssm model families on one
card, and ``launch/train.py`` (with ``optim/``, ``data/`` and ``ckpt/``)
trains them.  The online path (``core/des``, ``core/simulator.py``,
``core/trace.py``, ``cluster/``, ``obs/recorder.py`` and ``obs/report.py``)
runs on the host, as the reference's does, and ``launch/study.py`` runs the
paper's numerical and trace studies.
"""

from repro_torch.device import resolve_device  # noqa: F401
