"""Per-expert SwiGLU FFN on Hopper: ``kernel.moe_ffn_fwd`` (CUDA,
``csrc/moe_ffn.cu``, two launches a call) with its plain version, the op
``ops.moe_ffn`` and the plain oracle ``ref.moe_ffn_ref``."""

from repro_torch.kernels.moe_gemm.ops import moe_ffn  # noqa: F401
