"""GQA attention: full-sequence self attention (prefill, training; causal
or bidirectional), cross attention against a memory, one-token decode,
and the sequence-parallel decode over a cache sharded on its sequence.

The counterpart of ``repro/models/attention.py``.  Full-sequence and
cross attention go through the ``flash_fwd`` kernel, and in training its
backward through ``flash_dkv`` and ``flash_dq``
(:func:`repro_torch.kernels.flash_attention.flash_attention`); so does
cross attention in a decode step, whose one query row attends over the
whole memory, as the reference's does.  Self-attention decode attends
one new token over the KV cache with the plain
:func:`~repro_torch.kernels.flash_attention.ref.ref_attention`, as the
reference's ``attn_decode`` does.  Under a mesh (``ctx``) the
activations are DTensors constrained where the reference constrains
them, and decode attends with :func:`sp_decode_attention`: each rank
over its own slice of the cache's sequence (the whole sequence when the
cache is not sharded on it), the partial results combined by their
log-sum-exp.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import kv_heads_for
from repro_torch.kernels.flash_attention.ref import ref_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.init import ParamSpec
from repro_torch.models.layers import rms_norm, rope
from repro_torch.parallel.sharding import (
    ShardingCtx,
    all_reduce,
    is_dtensor,
    local_call,
    replicate_like,
    shard_start,
)

_NO_MESH = ShardingCtx.none()

__all__ = ["attn_specs", "cross_attn_specs", "attn_apply", "attn_decode", "cross_attn_apply",
           "memory_kv", "sp_decode_attention"]


def attn_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    """The projections (and the qk-norm scales); with ``cross`` also the
    scalar float32 ``gate`` of a gated cross-attention block, 0 at init."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    specs = {
        "wq": ParamSpec((d, hq, hd), ("embed", "q_heads", "head_dim"), dtype=cfg.pdtype),
        "wk": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim"), dtype=cfg.pdtype),
        "wv": ParamSpec((d, hkv, hd), ("embed", "kv_heads", "head_dim"), dtype=cfg.pdtype),
        "wo": ParamSpec((hq, hd, d), ("q_heads", "head_dim", "embed"), dtype=cfg.pdtype),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), (None,), init="ones", dtype=torch.float32)
        specs["k_norm"] = ParamSpec((hd,), (None,), init="ones", dtype=torch.float32)
    if cross:
        specs["gate"] = ParamSpec((), (), init="zeros", dtype=torch.float32)
    return specs


def cross_attn_specs(cfg: ModelConfig) -> dict:
    return attn_specs(cfg, cross=True)


def _heads(x: torch.Tensor, w: torch.Tensor, ctx: ShardingCtx, heads: str) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product; under a mesh the
    product's (h * k) columns are first placed as the logical ``heads``
    axis places h, so that they split back into whole heads."""
    d, h, k = w.shape
    # gathered over its FSDP axes first, so that the product (and its weight
    # gradient) keeps whole heads
    w = ctx.constrain(w.reshape(d, h * k), (None, "q_heads" if heads == "act_heads" else heads))
    if _seq_sharded(x):
        # DTensor (torch 2.11) cannot fold a sharded sequence (the vision
        # model's image tokens on "kv_seq" under the serving-weight layout)
        # into the rows of one matrix product: a batched product instead
        prod = torch.bmm(x, w.unsqueeze(0).expand(x.shape[0], d, h * k))
    else:
        prod = x @ w
    out = ctx.constrain(prod, ("batch", "seq", heads))
    return out.reshape(*x.shape[:-1], h, k)


def _seq_sharded(x: torch.Tensor) -> bool:
    """Whether ``x`` (B, S, D) is a DTensor whose sequence dim is sharded."""
    from torch.distributed.tensor import Shard

    return is_dtensor(x) and any(isinstance(a, Shard) and a.dim == 1 for a in x.placements)


def _project_q(p, x, cfg: ModelConfig, ctx: ShardingCtx, positions):
    """q (B, S, Hq, hd); RoPE at ``positions`` unless they are None."""
    q = _heads(x, p["wq"], ctx, "act_heads")
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
    return ctx.constrain(q, ("batch", "seq", "act_heads", "head_dim"))


def _project_kv(p, x, cfg: ModelConfig, ctx: ShardingCtx, positions):
    """(k, v) (B, S, Hkv, hd); RoPE on k at ``positions`` unless None."""
    k = _heads(x, p["wk"], ctx, "kv_heads")
    v = _heads(x, p["wv"], ctx, "kv_heads")
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:
        k = rope(k, positions, cfg.rope_theta)
    return (ctx.constrain(k, ("batch", "kv_seq", "kv_heads", "head_dim")),
            ctx.constrain(v, ("batch", "kv_seq", "kv_heads", "head_dim")))


def _out_proj(p, o, ctx: ShardingCtx):
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, k, d = p["wo"].shape
    wo = ctx.constrain(p["wo"].reshape(h * k, d), ("q_heads", None))
    out = o.reshape(*o.shape[:-2], h * k) @ wo
    return ctx.constrain(out, ("batch", "seq", "act_embed"))


def attn_apply(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    cfg: ModelConfig,
    positions: torch.Tensor,  # (B, S)
    *,
    causal: bool = True,
    window: int | None = None,
    ctx: ShardingCtx = _NO_MESH,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence self attention (prefill, training; ``causal=False``
    for an encoder); returns ``(out, (k, v))``, the projected keys and
    values being what the serving cache holds."""
    q = _project_q(p, x, cfg, ctx, positions)
    k, v = _project_kv(p, x, cfg, ctx, positions)
    o = flash_attention(q, k, v, causal=causal, window=window)
    return _out_proj(p, o, ctx), (k, v)


def cross_attn_apply(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    memory_kv: tuple[torch.Tensor, torch.Tensor],  # each (B, S_mem, Hkv, hd)
    cfg: ModelConfig,
    *,
    gated: bool = False,
    ctx: ShardingCtx = _NO_MESH,
) -> torch.Tensor:
    """Cross attention against a memory's precomputed K/V: no RoPE, no
    mask.  With ``gated`` (Llama-3.2-Vision) the output is scaled by
    ``tanh(gate)`` in the output's type; the gate is 0 at init, so an
    initialised model's cross blocks add nothing."""
    q = _project_q(p, x, cfg, ctx, positions=None)
    k, v = memory_kv
    out = _out_proj(p, flash_attention(q, k, v, causal=False), ctx)
    if gated:
        out = torch.tanh(p["gate"]).to(out.dtype) * out
    return out


def memory_kv(p: dict, memory: torch.Tensor, cfg: ModelConfig, ctx: ShardingCtx = _NO_MESH):
    """(k, v) of a memory (B, S_mem, D) for :func:`cross_attn_apply`,
    projected once a sequence: no RoPE."""
    return _project_kv(p, memory, cfg, ctx, positions=None)


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """cache[:, slot] = new[:, 0], IN PLACE.  Under a mesh each rank
    writes its own shard, and only the rank whose slice of the cache's
    sequence holds ``slot`` writes anything."""
    if not is_dtensor(cache):
        cache[:, slot] = new[:, 0].to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh, pl = cache.device_mesh, cache.placements
    # the new entry sharded as the cache is, except on its length-1 sequence
    want = tuple(Shard(a.dim) if isinstance(a, Shard) and a.dim != 1 else Replicate()
                 for a in pl)
    local_new = new.redistribute(mesh, want).to_local()
    off, n = shard_start(cache.shape[1], mesh, pl, 1)
    if off <= slot < off + n:
        cache.to_local()[:, slot - off] = local_new[:, 0].to(cache.dtype)


def attn_decode(
    p: dict,
    x: torch.Tensor,  # (B, 1, D)
    k_cache: torch.Tensor,  # (B, S_max, Hkv, hd)
    v_cache: torch.Tensor,
    pos: int,  # index of the new token
    cfg: ModelConfig,
    *,
    ring: bool = False,
    sp: bool = False,
    ctx: ShardingCtx = _NO_MESH,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token attention; returns ``(out, k_cache, v_cache)``.

    The caches are updated IN PLACE (the new token's K/V written at its
    slot) and returned, where the reference returns updated copies.
    ``ring=True`` treats the cache as a sliding-window ring buffer of
    width S_max.  Under a mesh the caches are DTensors and the attention
    is :func:`sp_decode_attention`; ``sp=True`` (long-context serving)
    constrains the cache's sequence to the rules' ``kv_seq`` axis first,
    as the reference's sequence-parallel path does.
    """
    positions = replicate_like(
        torch.full((x.shape[0], 1), pos, dtype=torch.int64, device=x.device), x)
    q = _project_q(p, x, cfg, ctx, positions)
    k_new, v_new = _project_kv(p, x, cfg, ctx, positions)
    s_max = k_cache.shape[1]
    slot = pos % s_max if ring else min(pos, s_max - 1)
    _write_slot(k_cache, k_new, slot)
    _write_slot(v_cache, v_new, slot)
    kv_len = min(pos + 1, s_max)
    if is_dtensor(q):
        if sp:
            logical = ("batch", "kv_seq", "kv_heads", "head_dim")
            k_cache, v_cache = ctx.constrain(k_cache, logical), ctx.constrain(v_cache, logical)
        o = sp_decode_attention(q, k_cache, v_cache, kv_len, ctx)
    else:
        # ring buffers hold a rotation of the window; softmax attention does
        # not depend on the order of the keys.
        o = ref_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype), causal=False,
                          kv_len=kv_len)
    return _out_proj(p, o, ctx), k_cache, v_cache


def sp_decode_attention(
    q: torch.Tensor,  # (B, 1, Hq, hd) DTensor: heads over the rules' act_heads axes
    k_cache: torch.Tensor,  # (B, S, Hkv, hd) DTensor: S sharded (or not) over some mesh axes
    v_cache: torch.Tensor,
    kv_len: int,
    ctx: ShardingCtx,
) -> torch.Tensor:
    """Distributed flash-decode: each rank attends over its own slice of the
    cache's sequence in float32 (keys at ``seq_off + arange(s_loc) >=
    kv_len`` masked, a non-finite local max taken as -1e30), and the
    slices are combined by three all-reduces over the mesh axes that shard
    the sequence: the max (MAX), then the denominator and the numerator
    (SUM).  The numerator comes after the denominator: each rank divides
    its P by the global denominator and rounds it to V's type before its
    P V product, as the oracle ``ref_attention`` does, so a mesh of one
    rank computes the oracle's numbers.  Local query heads are a
    contiguous slice of the global heads, so their GQA KV heads are chosen
    by GLOBAL head index (a slice of whole groups, attended grouped as the
    oracle does).  Returns o (B, 1, Hq, hd) in q's type, placed as
    q."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    hq, hkv = q.shape[2], k_cache.shape[2]
    group = hq // hkv
    # the cache keeps its batch and sequence shards (its KV heads
    # replicate); q follows the cache's batch shards, replicates over the
    # axes that shard the sequence, and keeps its head shards elsewhere
    kpl = tuple(Shard(a.dim) if isinstance(a, Shard) and a.dim in (0, 1) else Replicate()
                for a in k_cache.placements)
    qpl = tuple(Shard(0) if k == Shard(0) else
                Shard(2) if k != Shard(1) and a == Shard(2) else Replicate()
                for a, k in zip(q.placements, kpl))
    seq_axes = [mesh.mesh_dim_names[i] for i, a in enumerate(kpl) if a == Shard(1)]
    groups = [mesh.get_group(a) for a in seq_axes]
    seq_off, s_loc = shard_start(k_cache.shape[1], mesh, kpl, 1)
    head_off, _ = shard_start(hq, mesh, qpl, 2)

    def local(q, k, v):
        b, sq, hq_loc, d = q.shape
        k, v = kv_heads_for(k, v, head_off, hq_loc, group)
        n_kv = k.shape[2]
        qg = q.reshape(b, sq, n_kv, hq_loc // n_kv, d).float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * d**-0.5
        valid = torch.arange(s_loc, device=q.device) + seq_off < kv_len
        s = torch.where(valid, s, -torch.inf)
        m = s.amax(dim=-1, keepdim=True)
        m = all_reduce(torch.where(torch.isfinite(m), m, torch.full_like(m, -1e30)), "max",
                       groups)
        p = torch.where(valid, torch.exp(s - m), 0.0)
        den = all_reduce(p.sum(dim=-1, keepdim=True), "sum", groups)
        p = (p / den.clamp(min=1e-30)).to(v.dtype).float()
        num = all_reduce(torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()), "sum", groups)
        return num.reshape(b, sq, hq_loc, d).to(q.dtype)

    return local_call(local, (q, k_cache, v_cache), (qpl, kpl, kpl), qpl, mesh)
