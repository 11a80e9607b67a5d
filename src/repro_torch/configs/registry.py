"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The counterpart of ``repro/configs/registry.py``.  It knows the same ten
architecture ids.  The dense, moe and ssm ones are built here; for the
hybrid, vlm and encdec families :func:`get_config` and :func:`get_smoke`
raise ``NotImplementedError`` naming the slice of the port (ROADMAP,
"Port status") that brings them.  ``get_config(arch, **overrides)``
replaces fields, e.g. ``n_layers`` to cut a model's depth to one card.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "PENDING", "get_config", "get_smoke", "list_archs"]

#: arch id -> module name under repro_torch.configs (the ported families)
ARCHS = {
    "mixtral-8x22b": "mixtral_8x22b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "mamba2-1.3b": "mamba2_1_3b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen3-8b": "qwen3_8b",
    "granite-3-8b": "granite_3_8b",
    "llama3-8b": "llama3_8b",
}

_REST = "port slice 8 (the hybrid, vlm and encdec families: period stacks, cross attention)"
#: arch id -> (family, the ROADMAP slice that brings it)
PENDING = {
    "jamba-v0.1-52b": ("hybrid", _REST),
    "llama-3.2-vision-11b": ("vlm", _REST),
    "seamless-m4t-large-v2": ("encdec", _REST),
}


def _module(arch: str):
    if arch in PENDING:
        family, where = PENDING[arch]
        raise NotImplementedError(f"{arch} ({family} family) is not ported yet: ROADMAP {where}")
    try:
        mod = ARCHS[arch]
    except KeyError:
        raise ValueError(f"unknown arch {arch!r}; options: {list_archs()}") from None
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).SMOKE
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def list_archs() -> list[str]:
    """Every architecture id, ported or not (as the reference lists them)."""
    return sorted([*ARCHS, *PENDING])
