"""Model configuration of the port: the dense decoder family.

The counterpart of ``repro/models/config.py``, carrying the fields the
dense family (Qwen3, Llama-3, Granite) reads.  The dtypes are
``torch.dtype`` properties (:attr:`ModelConfig.dtype`,
:attr:`ModelConfig.pdtype`) made from the reference's dtype names, so a
config written for one package reads the same in the other.  The other
families of the reference (moe, ssm, hybrid, encdec, vlm) come with
later slices of the port: a config of theirs raises
``NotImplementedError``, and so does :mod:`repro_torch.configs.registry`
for their architectures.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ModelConfig", "FAMILIES"]

#: Families this package builds.
FAMILIES = ("dense",)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    sliding_window: int | None = None
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise NotImplementedError(f"family {self.family!r} is not ported; see ROADMAP")
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        for field in ("param_dtype", "compute_dtype"):
            if not isinstance(getattr(torch, getattr(self, field), None), torch.dtype):
                raise ValueError(f"{field}={getattr(self, field)!r} is not a torch dtype")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def param_count(self) -> int:
        """Parameters as the reference counts them: the padded embedding
        (and the untied head), then per layer the attention projections and
        the SwiGLU MLP; the norms' vectors are left out."""
        d, v, hd = self.d_model, self.padded_vocab, self.hd
        total = v * d * (1 if self.tie_embeddings else 2)
        attn = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
        return total + self.n_layers * (attn + 3 * d * self.d_ff)
