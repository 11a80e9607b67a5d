"""Model plane of the port: the dense, moe, ssm, hybrid, encdec and vlm
families, for serving and training.

* :mod:`repro_torch.models.config`      — ModelConfig
* :mod:`repro_torch.models.init`        — ParamSpec trees, materialization,
  and :func:`~repro_torch.models.init.from_reference`
* :mod:`repro_torch.models.layers`      — RMSNorm, RoPE, SwiGLU MLP, embeddings,
  cross-entropy
* :mod:`repro_torch.models.attention`   — GQA self-attention (through the
  ``flash_fwd`` kernel, and ``flash_dkv`` / ``flash_dq`` in the backward),
  cross attention against a memory's K/V, and one-token decode against a KV
  cache
* :mod:`repro_torch.models.frontends`   — stub audio-frame and image embeddings
* :mod:`repro_torch.models.moe`         — router, capacity dispatch, expert FFN
* :mod:`repro_torch.models.ssm`         — the Mamba-2 mixer
* :mod:`repro_torch.models.transformer` — block assembly (uniform stacks,
  periods, the encoder), ``lm_loss``, prefill, ``prime_memory``, decode
"""

from repro_torch.models.config import ModelConfig  # noqa: F401
