"""FlashAttention forward on Hopper: ``kernel.flash_fwd`` (CUDA,
``csrc/flash_fwd.cu``) with its plain version, the (B, S, H, D) op
``ops.flash_attention`` and the plain oracle ``ref.ref_attention``."""

from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
