"""Checkpointing of the port: ``checkpoint.CheckpointManager``."""

from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: F401
