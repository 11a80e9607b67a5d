"""Model configuration of the port: one dataclass for the six families.

The counterpart of ``repro/models/config.py``.  Families:

* dense  — decoder-only GQA transformer (Qwen3, Granite, Llama-3);
* moe    — dense plus a mixture-of-experts FFN (Mixtral, Kimi-K2);
* ssm    — a pure Mamba-2 stack (Mamba2);
* hybrid — Jamba's attention:Mamba interleave in periods of
  ``attn_period`` positions, with periodic MoE FFNs;
* encdec — an encoder over stub audio-frame embeddings and a decoder
  with cross attention (Seamless-M4T);
* vlm    — a decoder with one gated cross-attention block a period of
  ``cross_attn_period`` into stub image embeddings (Llama-3.2-Vision).

The dtypes are ``torch.dtype`` properties (:attr:`ModelConfig.dtype`,
:attr:`ModelConfig.pdtype`) made from the reference's dtype names, so a
config written for one package reads the same in the other.  ``remat``
and ``logit_chunk`` are read by training
(:func:`repro_torch.models.transformer.lm_loss`), with the reference's
defaults.  There are no ``*_impl``, ``attn_block_*``, ``scan_layers``
or ``moe_ep`` fields: the device decides between a kernel and its plain
version, the kernels fix their own tiles, the layers run in a Python
loop, and there is one device.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ModelConfig", "FAMILIES"]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
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

    # --- hybrid (Jamba) ------------------------------------------------------
    attn_period: int = 0  # within each period, position attn_offset is attention
    attn_offset: int = 4

    # --- encoder-decoder -----------------------------------------------------
    n_enc_layers: int = 0
    frontend_frames: int = 0  # stub audio frontend sequence length

    # --- vlm -----------------------------------------------------------------
    cross_attn_period: int = 0  # one cross-attn layer per period (position 0)
    num_image_tokens: int = 0

    # --- numerics / execution ------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"  # "none" | "full" | "dots": what a training block keeps
    vocab_pad_multiple: int = 256
    logit_chunk: int = 0  # 0 = unchunked cross-entropy; >0 = vocab chunking

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
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

    def is_attn_layer(self, layer: int) -> bool:
        """hybrid only: which positions in the period are attention."""
        if self.family != "hybrid":
            return True
        return layer % self.attn_period == self.attn_offset

    def param_count(self, active_only: bool = False) -> int:
        """Parameters as the reference counts them: the padded embedding
        (and the untied head), then per decoder layer its mixer (attention,
        twice for a vlm cross layer, or the Mamba-2 mixer) and its FFN (the
        SwiGLU MLP, or the experts, ``top_k`` of them with ``active_only``,
        and the router); for encdec the encoder's attention and MLP blocks
        and each decoder layer's cross attention.  The norms' vectors and
        the vlm gates are left out."""
        d, v = self.d_model, self.padded_vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        attn = (d * (self.n_heads + self.n_kv_heads) * self.hd * 2) if self.n_heads else 0
        mlp = 3 * d * self.d_ff
        experts = self.top_k if active_only else self.n_experts
        din, g, n, h = self.d_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
        mamba = (d * din * 2 + d * 2 * g * n + d * h + self.ssm_conv * (din + 2 * g * n)
                 + 3 * h + din + din * d)
        for layer in range(self.n_layers):
            if self.family == "ssm":
                total += mamba
                continue
            if self.family == "hybrid":
                total += attn if self.is_attn_layer(layer) else mamba
            elif self.family == "vlm" and self.cross_attn_period and (
                    layer % self.cross_attn_period == 0):
                total += 2 * attn  # self and gated cross
            else:
                total += attn
            if self.is_moe_layer(layer):
                total += 3 * d * self.d_ff * experts + d * self.n_experts
            elif self.d_ff:
                total += mlp
        if self.family == "encdec":
            total += self.n_enc_layers * (attn + mlp) + self.n_layers * attn
        return total
