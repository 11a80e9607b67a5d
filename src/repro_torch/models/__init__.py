"""Model plane of the port: the dense decoder family, for serving.

* :mod:`repro_torch.models.config`      — ModelConfig (dense family)
* :mod:`repro_torch.models.init`        — ParamSpec trees, materialization,
  and :func:`~repro_torch.models.init.from_reference`
* :mod:`repro_torch.models.layers`      — RMSNorm, RoPE, SwiGLU MLP, embeddings
* :mod:`repro_torch.models.attention`   — GQA self-attention (prefill through
  the ``flash_fwd`` kernel) and one-token decode against a KV cache
* :mod:`repro_torch.models.transformer` — block assembly, prefill, decode
"""

from repro_torch.models.config import ModelConfig  # noqa: F401
