"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The counterpart of ``repro/configs/registry.py``.  It builds the same ten
architecture ids.  ``get_config(arch, **overrides)`` replaces fields,
e.g. ``n_layers`` to cut a model's depth to one card.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config", "get_smoke", "list_archs"]

#: arch id -> module name under repro_torch.configs
ARCHS = {
    "mixtral-8x22b": "mixtral_8x22b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "mamba2-1.3b": "mamba2_1_3b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen3-8b": "qwen3_8b",
    "granite-3-8b": "granite_3_8b",
    "llama3-8b": "llama3_8b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}


def _module(arch: str):
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
    return sorted(ARCHS)
