"""FlashAttention on Hopper: ``kernel.flash_fwd`` (CUDA,
``csrc/flash_fwd.cu``) and the backward's ``kernel.flash_dkv`` and
``kernel.flash_dq`` (``csrc/flash_bwd.cu``) with their plain versions,
the differentiable (B, S, H, D) op ``ops.flash_attention`` and the plain
oracle ``ref.ref_attention``."""

from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: F401
