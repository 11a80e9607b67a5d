"""Data pipeline: deterministic synthetic LM streams + memmapped token files.

The counterpart of ``repro/data/pipeline.py``: pure NumPy, so the same
(seed, step) gives the same arrays in both packages, array for array.
The trainer moves a batch to its device (:mod:`repro_torch.launch.train`);
:func:`make_batch_specs` gives the dry run's ``meta`` stand-ins.

Design goals (scale-out):

* **Determinism under restart/elasticity** — batches are a pure function
  of (seed, step), never of worker state, so a job restarted from step k
  (fault tolerance) or re-sharded onto a different slice (elastic
  scaling) sees exactly the same token stream.
* **Shardability** — batches are produced host-side as numpy; in a
  multi-host deployment each host materializes only its addressable
  shard (the per-host slice is again a pure function of (seed, step,
  shard_index)).
* **Model-agnostic** — the same batch dict feeds every architecture;
  encdec/vlm extras (stub frontend embeddings) are generated per-config.

The synthetic stream is a order-k Markov chain over the vocabulary with
hashed transitions — it has learnable structure (loss drops measurably
within hundreds of steps, used by the examples and the cluster manager's
early-termination metric gates) while requiring no data files.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "TokenFileDataset", "make_batch_specs"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_order: int = 2
    pad_id: int = -1


class SyntheticLM:
    """Deterministic synthetic LM batches: hashed order-k Markov chain."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # hashed transition table: next = h(ctx) mixed with noise
        self._mix = np.uint64(0x9E3779B97F4A7C15)

    def _hash(self, x: np.ndarray) -> np.ndarray:
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))

    def batch(self, step: int) -> dict:
        """Batch for a global step: tokens (B, S), labels (B, S)."""
        cfg = self.cfg
        b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        rng = np.random.default_rng(np.uint64(cfg.seed) + np.uint64(step) * np.uint64(1000003))
        toks = np.empty((b, s), np.int64)
        toks[:, 0] = rng.integers(0, v, size=b)
        ctx = toks[:, 0].astype(np.uint64) + np.uint64(cfg.seed)
        noise = rng.integers(0, 16, size=(b, s))
        for t in range(1, s):
            h = self._hash(ctx * self._mix)
            # mostly-deterministic next token + small noise: learnable
            toks[:, t] = (h + noise[:, t].astype(np.uint64)) % np.uint64(v)
            ctx = self._hash(ctx ^ toks[:, t].astype(np.uint64))
        labels = np.concatenate([toks[:, 1:], np.full((b, 1), cfg.pad_id)], axis=1)
        return {
            "tokens": toks.astype(np.int32),
            "labels": labels.astype(np.int32),
        }


class TokenFileDataset:
    """Memmapped flat int32 token file, deterministic strided sampling."""

    def __init__(self, path: str, cfg: DataConfig):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.n_windows = (len(self.tokens) - 1) // cfg.seq_len

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(np.uint64(cfg.seed) + np.uint64(step))
        idx = rng.integers(0, self.n_windows, size=cfg.global_batch)
        starts = idx * cfg.seq_len
        toks = np.stack([self.tokens[s : s + cfg.seq_len] for s in starts])
        labels = np.stack([self.tokens[s + 1 : s + 1 + cfg.seq_len] for s in starts])
        return {"tokens": toks.astype(np.int32), "labels": labels.astype(np.int32)}


def make_batch_specs(cfg: DataConfig) -> dict:
    """``meta`` int32 tensors of a batch's shapes (dry-run stand-ins;
    nothing allocated)."""
    import torch

    shape = (cfg.global_batch, cfg.seq_len)
    return {k: torch.empty(shape, dtype=torch.int32, device="meta") for k in ("tokens", "labels")}
