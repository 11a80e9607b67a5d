"""Assigned input shapes and the (arch x shape) cell matrix.

The counterpart of ``repro/configs/shapes.py``.  Shapes (seq_len x
global_batch):

  train_4k     4,096 x 256   -> train step
  prefill_32k  32,768 x 32   -> prefill (logits + serving cache)
  decode_32k   32,768 x 128  -> decode step (1 new token, 32k KV cache)
  long_500k    524,288 x 1   -> decode step, sequence-parallel cache

``long_500k`` needs sub-quadratic attention or a bounded cache: it runs
for mamba2 (O(1) state), jamba (4 of 32 layers hold the 500k KV,
sequence-sharded) and mixtral (a sliding-window ring cache of 4096); the
pure full-attention archs skip it.  :func:`input_specs` gives ``meta``
tensors (nothing allocated) of the reference's shapes and dtypes.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.models.config import ModelConfig

__all__ = ["SHAPES", "ShapeSpec", "LONG_OK", "arch_shape_config", "input_specs",
           "runnable_cells"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

#: archs whose long_500k cell is runnable (sub-quadratic / bounded cache)
LONG_OK = {"mamba2-1.3b", "jamba-v0.1-52b", "mixtral-8x22b"}


def arch_shape_config(arch: str, shape: str) -> ModelConfig:
    """The arch's config for a shape (an encdec's frames track the sequence)."""
    cfg = get_config(arch)
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, frontend_frames=SHAPES[shape].seq_len)
    return cfg


def input_specs(arch: str, shape: str) -> dict:
    """``meta`` stand-ins for every model input of the cell: train
    {tokens, labels}, prefill {tokens}, decode {token, pos} (int32, ``pos``
    0-d), plus ``enc_frames`` (encdec) or ``image_embeds`` (vlm) in the
    working type outside decode.  The decode cache is the launcher's
    (``transformer.abstract_cache``)."""
    cfg = arch_shape_config(arch, shape)
    spec = SHAPES[shape]
    b, s = spec.global_batch, spec.seq_len

    def meta(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    out: dict = {}
    if spec.kind == "train":
        out["tokens"] = meta((b, s))
        out["labels"] = meta((b, s))
    elif spec.kind == "prefill":
        out["tokens"] = meta((b, s))
    else:
        out["token"] = meta((b, 1))
        out["pos"] = meta(())
    if cfg.family == "encdec" and spec.kind != "decode":
        out["enc_frames"] = meta((b, cfg.frontend_frames, cfg.d_model), cfg.dtype)
    if cfg.family == "vlm" and spec.kind != "decode":
        out["image_embeds"] = meta((b, cfg.num_image_tokens, cfg.d_model), cfg.dtype)
    return out


def runnable_cells() -> list[tuple[str, str]]:
    """All (arch, shape) cells minus the long_500k skips."""
    return [(arch, shape) for arch in list_archs() for shape in SHAPES
            if shape != "long_500k" or arch in LONG_OK]
