"""Mamba-2 SSD scan on Hopper: ``kernel.ssd_fwd`` (CUDA,
``csrc/ssd_fwd.cu``) with its plain version, the (B, S, H, P) op
``ops.ssd_scan`` and the plain oracles of ``ref``."""

from repro_torch.kernels.ssd_scan.ops import ssd_scan  # noqa: F401
