"""Modality frontend stubs: the backbones of the encdec and vlm families
take precomputed frame or patch embeddings, which these stand in for.

The counterpart of ``repro/models/frontends.py``.  The two stubs draw
from an explicit ``torch.Generator`` on the output's device; their
numbers differ from the reference's for the same seed (the tests feed
both packages the same NumPy arrays instead).
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["audio_frames_stub", "image_embeds_stub", "frontend_shapes", "make_extras"]


def frontend_shapes(cfg: ModelConfig, batch: int) -> dict:
    """Extra model inputs (beyond tokens) per family, as shape dicts."""
    if cfg.family == "encdec":
        return {"enc_frames": (batch, cfg.frontend_frames, cfg.d_model)}
    if cfg.family == "vlm":
        return {"image_embeds": (batch, cfg.num_image_tokens, cfg.d_model)}
    return {}


def _stub(generator: torch.Generator, shape: tuple, cfg: ModelConfig) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, dtype=torch.float32, device=generator.device)
    return (0.02 * x).to(cfg.dtype)


def audio_frames_stub(generator: torch.Generator, cfg: ModelConfig, batch: int) -> torch.Tensor:
    """Precomputed speech-frame embeddings (B, frontend_frames, D), as a
    50 Hz fbank and conv stack would give them: 0.02 x standard normal."""
    return _stub(generator, (batch, cfg.frontend_frames, cfg.d_model), cfg)


def image_embeds_stub(generator: torch.Generator, cfg: ModelConfig, batch: int) -> torch.Tensor:
    """Precomputed ViT patch embeddings (B, num_image_tokens, D) (560 px
    / 14 -> 1601 tokens, padded): 0.02 x standard normal."""
    return _stub(generator, (batch, cfg.num_image_tokens, cfg.d_model), cfg)


def make_extras(generator: torch.Generator, cfg: ModelConfig, batch: int) -> dict:
    """The batch's extras for ``cfg``'s family from the stubs: ``enc_frames``
    (encdec), ``image_embeds`` (vlm), or nothing."""
    if cfg.family == "encdec":
        return {"enc_frames": audio_frames_stub(generator, cfg, batch)}
    if cfg.family == "vlm":
        return {"image_embeds": image_embeds_stub(generator, cfg, batch)}
    return {}
