"""Model configuration of the port: the dense, moe and ssm families.

The counterpart of ``repro/models/config.py``, carrying the fields those
families read: the dense decoder (Qwen3, Llama-3, Granite), the
mixture-of-experts decoder (Mixtral, Kimi-K2) and the pure Mamba-2 stack
(Mamba2).  The dtypes are ``torch.dtype`` properties
(:attr:`ModelConfig.dtype`, :attr:`ModelConfig.pdtype`) made from the
reference's dtype names, so a config written for one package reads the
same in the other.  ``remat`` and ``logit_chunk`` are read by training
(:func:`repro_torch.models.transformer.lm_loss`), with the reference's
defaults.  The other families of the reference (hybrid, encdec, vlm)
come with a later slice of the port: a config of theirs raises
``NotImplementedError``, and so does :mod:`repro_torch.configs.registry`
for their architectures.  There are no ``*_impl`` fields: the device
decides between a kernel and its plain version.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ModelConfig", "FAMILIES"]

#: Families this package builds.
FAMILIES = ("dense", "moe", "ssm")
#: What a training block saves for the backward (``transformer._maybe_remat``).
REMAT = ("none", "full", "dots")


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

    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_period: int = 1  # a layer l is MoE iff l % moe_period == moe_offset
    moe_offset: int = 0
    moe_group: int = 1024  # tokens per dispatch group

    # --- SSM (Mamba-2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # --- numerics / execution ------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"  # "none" | "full" | "dots": what a training block keeps
    vocab_pad_multiple: int = 256
    logit_chunk: int = 0  # 0 = unchunked cross-entropy; >0 = vocab chunking

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise NotImplementedError(f"family {self.family!r} is not ported; see ROADMAP")
        if self.family != "ssm" and self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.remat not in REMAT:
            raise ValueError(f"remat={self.remat!r}; options: {REMAT}")
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
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def is_moe_layer(self, layer: int) -> bool:
        if self.n_experts == 0:
            return False
        return layer % self.moe_period == self.moe_offset

    def param_count(self, active_only: bool = False) -> int:
        """Parameters as the reference counts them: the padded embedding
        (and the untied head), then per layer the attention projections and
        the SwiGLU MLP, or the experts (``top_k`` of them with
        ``active_only``) and the router, or the Mamba-2 mixer; the norms'
        vectors are left out."""
        d, v = self.d_model, self.padded_vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            din, g, n, h = self.d_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
            mamba = (d * din * 2 + d * 2 * g * n + d * h + self.ssm_conv * (din + 2 * g * n)
                     + 3 * h + din + din * d)
            return total + self.n_layers * mamba
        attn = d * self.n_heads * self.hd * 2 + d * self.n_kv_heads * self.hd * 2
        experts = self.top_k if active_only else self.n_experts
        for layer in range(self.n_layers):
            if self.is_moe_layer(layer):
                total += attn + 3 * d * self.d_ff * experts + d * self.n_experts
            else:
                total += attn + (3 * d * self.d_ff if self.d_ff else 0)
        return total
