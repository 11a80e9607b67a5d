"""Core library of the port: the paper's scheduling contribution.

* :class:`repro_torch.core.jobs.JobSpec` and workload generators (§IV-A2)
* :mod:`repro_torch.core.policies` — RANK (Eq. 23), SERPT, SR/Gittins,
  with conditional (stage-level) index tables
* :mod:`repro_torch.core.evaluator` — exact / streamed Monte-Carlo
  expected sojourn of successful jobs on the CUDA card, exhaustive OPTIMAL
* :mod:`repro_torch.core.theory` — Theorem III.2 / Lemma III.3 numerics
* :mod:`repro_torch.core.simulator` — multi-server online DES (paper §V),
  host code over :mod:`repro_torch.core.des`
* :mod:`repro_torch.core.trace` — Philly-statistics trace synthesis (§VI-A)
"""

from repro_torch.core.jobs import JobSpec, generate_workload, pad_workload  # noqa: F401
from repro_torch.core.policies import (  # noqa: F401
    erpt_values,
    rank_order,
    rank_values,
    sr_rank_values,
)
from repro_torch.core.evaluator import evaluate, evaluate_many, optimal_order  # noqa: F401
from repro_torch.core.simulator import SimResult, simulate  # noqa: F401
from repro_torch.core.trace import synthesize_trace  # noqa: F401
