"""Fused dynamic-policy (SR / SERPT / conditional-RANK) sojourn evaluator.

The counterpart of ``repro/kernels/sojourn_eval/dynamic.py``.  Each
outcome combination (exact enumeration) or sample (streamed Monte Carlo)
is simulated on ``n_servers = W`` homogeneous servers with preemption at
stage boundaries: every step pops the running job with the earliest
``busy_until`` and seats the queued job with the minimum conditional
index ``idx[j, stage_j]`` on the freed server, ties to the lowest job
position.  The weighted means of the successful and of all jobs'
completion times are Eqs. (7)-(9).

* ``dynamic_sojourn_enum`` / ``dynamic_sojourn_mc`` — wrappers of the
  CUDA kernel in ``csrc/sojourn_dynamic.cu`` (design note there), which
  replace the TPU kernels of the same names.  A CUDA tensor launches the
  kernel or raises; a CPU tensor runs the plain version.  The kernel
  simulates on a total order of the policy's (job, stage) entries
  (:func:`queue_tables`) with a queue bitmask: up to ``REGISTER_WORDS``
  mask words and ``REGISTER_SERVERS`` servers in registers, past either
  in shared memory and, past ``SHARED_STATE_BYTES`` a block, in device
  scratch that the wrapper allocates, so the job count is limited by
  memory only, as the reference's is.  With
  :mod:`repro_torch.obs.profiling` on, each launch adds the N M entries of
  its tables to the counter ``prof.ops.dynamic_entries``: they set the
  mask words, and so the register path against the memory path.
* ``dynamic_sojourn_enum_torch`` / ``dynamic_sojourn_mc_torch`` — the
  plain versions: the identical state machine with the job axis
  vectorized (:func:`_sim_tile_torch`, the counterpart of
  ``_sim_tile_xla``), over tiles of the index range.
* :func:`sojourn_eval_dynamic` — the public op on NumPy workload arrays.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.sojourn_eval import kernel as K
from repro_torch.kernels.sojourn_eval import rng
from repro_torch.kernels.sojourn_eval.ref import mixed_radix_strides
from repro_torch.obs import profiling

__all__ = [
    "REGISTER_WORDS",
    "REGISTER_SERVERS",
    "SHARED_STATE_BYTES",
    "QueueTables",
    "queue_tables",
    "digit_fields",
    "mask_words",
    "launches",
    "sojourn_eval_dynamic",
    "dynamic_kernel_args",
    "dynamic_sojourn_enum",
    "dynamic_sojourn_mc",
    "dynamic_sojourn_enum_torch",
    "dynamic_sojourn_mc_torch",
]

#: Queue-mask words the kernel holds in registers (its templates 1, 2 and
#: 4): tables of up to 256 (job, stage) entries.
REGISTER_WORDS = 4
#: Servers whose slots the kernel holds in registers (templates 1, 2, 4, 8).
REGISTER_SERVERS = 8
#: Bytes of a thread's state on the memory path: 16 for each mask word (the
#: queue's and the stops') and for each server slot (busy_until, rank, job).
STATE_BYTES = 16
#: A block's state in shared memory on the memory path, at most
#: (``kSharedStateBytes``); past that it goes to device scratch.
SHARED_STATE_BYTES = 96 * 1024
#: Combination indices per tile of the plain versions.
PLAIN_TILE = 1 << 15

#: Kernel launches per wrapper since the last reset (set to 0 to reset).
launches = {"dynamic_sojourn_enum": 0, "dynamic_sojourn_mc": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint
_SIGNATURES = {
    "dynamic_enum_launch": [_P] * 8 + [_I, _I, _I, _I, _LL, _I, _I, _P, _I, _P, _P, _P],
    "dynamic_mc_launch": [_P] * 6 + [_I, _I, _I, _I, _LL, _U, _U, _I, _I, _P, _I, _P, _P, _P],
}


# ---------------------------------------------------------------------------
# Plain versions: lockstep simulation with the job axis vectorized
# ---------------------------------------------------------------------------


def _sim_tile_torch(s, succ, idx_table, stage_durs, *, total_stages, n_servers=1):
    """Lockstep W-server simulation of one tile, job axis vectorized.

    ``s`` is the (T, N) decoded stop-stage matrix (mixed radix or the
    Threefry stream).  Returns per-lane ``(tot, tsum, cnt)``: summed
    successful completion times, summed completion times, successes.
    ``argmin`` keeps the first minimum, as the kernels' strict ``<``
    running minimum does.

    The dispatch follows the reference's Pallas kernel (the strict ``<``
    running minimum from +inf of ``_lockstep_sim._dispatch_one`` in
    ``repro/kernels/sojourn_eval/dynamic.py``), which the CUDA kernel's
    ranks reproduce: a NaN index is mapped to +inf and never seated, a
    -inf index is seated first, and a job is seated when the minimum is
    ``< inf``.  On NaN and
    -inf indices this departs on purpose from the reference's XLA path
    (``_sim_tile_xla``), which seats only a finite minimum (ROADMAP R7);
    on finite and +inf tables the two agree.
    """
    tile, n = s.shape
    m = idx_table.shape[1]
    dev, dtype = stage_durs.device, stage_durs.dtype
    inf = torch.tensor(torch.inf, dtype=dtype, device=dev)
    job_ids = torch.arange(n, device=dev)[None, :]
    w_srv = min(n_servers, n)

    def tables(stage):
        st = stage.clamp(max=m - 1)
        ok = stage < m
        idx = torch.where(ok, idx_table[job_ids, st], inf)
        dur = torch.where(ok, stage_durs[job_ids, st], 0.0)
        return idx, dur

    def dispatch_one(stage, busy, nbusy, clock):
        idx, dur = tables(stage)
        queued = (busy == inf) & (stage <= s)
        idxq = torch.where(queued & ~torch.isnan(idx), idx, inf)
        j = torch.argmin(idxq, dim=1)  # first minimum: ties by position
        can = (nbusy < w_srv) & (idxq.min(dim=1).values < inf)
        sel = (j[:, None] == job_ids) & can[:, None] & queued
        busy = torch.where(sel, clock[:, None] + dur, busy)
        return busy, nbusy + can.to(torch.int64)

    zf = torch.zeros(tile, dtype=dtype, device=dev)
    stage = torch.zeros((tile, n), dtype=torch.int64, device=dev)
    busy = torch.full((tile, n), torch.inf, dtype=dtype, device=dev)
    nbusy = torch.zeros(tile, dtype=torch.int64, device=dev)
    for _ in range(w_srv):  # t=0: seat the W smallest-index jobs
        busy, nbusy = dispatch_one(stage, busy, nbusy, zf)
    clock, tot, tsum = zf, zf, zf
    cnt = torch.zeros(tile, dtype=torch.int64, device=dev)
    for _ in range(total_stages):
        tmin = busy.min(dim=1).values
        cj = torch.argmin(busy, dim=1)  # earliest finish; ties by position
        has = torch.isfinite(tmin)  # all-idle lanes: no-op
        clock = torch.where(has, tmin, clock)
        sel = (cj[:, None] == job_ids) & has[:, None]
        fin = sel & (stage == s)
        fin_any = fin.any(dim=1)
        fin_succ = (fin & succ).any(dim=1)
        tot = tot + torch.where(fin_succ, clock, 0.0)
        cnt = cnt + fin_succ.to(torch.int64)
        tsum = tsum + torch.where(fin_any, clock, 0.0)
        stage = stage + sel.to(torch.int64)
        busy = torch.where(sel, inf, busy)
        nbusy = nbusy - has.to(torch.int64)
        busy, nbusy = dispatch_one(stage, busy, nbusy, clock)
    return tot, tsum, cnt


def _reduce_tile(s, radix, w, idx_tables, stage_durs, total_stages, n_servers,
                 e_succ, e_all) -> None:
    """Simulate one tile under every policy and add Eqs. (7)-(9) in place."""
    n = s.shape[1]
    succ = s == radix[None, :] - 1
    for p in range(idx_tables.shape[0]):
        tot, tsum, cnt = _sim_tile_torch(
            s, succ, idx_tables[p], stage_durs,
            total_stages=total_stages, n_servers=n_servers,
        )
        mean = torch.where(cnt > 0, tot / cnt.clamp(min=1), 0.0)
        e_succ[p] += w @ mean
        e_all[p] += w @ (tsum / n)


def dynamic_sojourn_enum_torch(probs, stage_durs, idx_tables, strides, radix,
                               k_total, total_stages, n_servers=1):
    """Plain version of :func:`dynamic_sojourn_enum` on any device."""
    n = probs.shape[0]
    dev = probs.device
    strides = strides.to(torch.int64)
    radix = radix.to(torch.int64)
    job_ids = torch.arange(n, device=dev)[None, :]
    e_succ = torch.zeros(idx_tables.shape[0], dtype=torch.float64, device=dev)
    e_all = torch.zeros_like(e_succ)
    for lo in range(0, k_total, PLAIN_TILE):
        k = torch.arange(lo, min(lo + PLAIN_TILE, k_total), device=dev)
        s = (k[:, None] // strides[None, :]) % radix[None, :]  # (T, N) decode
        w = probs[job_ids, s].prod(dim=1)  # Eq. (8)
        _reduce_tile(s, radix, w, idx_tables, stage_durs, total_stages, n_servers,
                     e_succ, e_all)
    return e_succ, e_all


def dynamic_sojourn_mc_torch(cdf, stage_durs, idx_tables, radix, seed, n_samples,
                             total_stages, n_servers=1):
    """Plain version of :func:`dynamic_sojourn_mc` on any device."""
    n = cdf.shape[0]
    dev = cdf.device
    key = rng.split_seed(seed)
    radix = radix.to(torch.int64)
    job_ids = torch.arange(n, device=dev)[None, :]
    e_succ = torch.zeros(idx_tables.shape[0], dtype=torch.float64, device=dev)
    e_all = torch.zeros_like(e_succ)
    for lo in range(0, n_samples, PLAIN_TILE):
        k = torch.arange(lo, min(lo + PLAIN_TILE, n_samples), device=dev)
        bits, _ = rng.threefry2x32_torch(key, k[:, None].expand(-1, n), job_ids.expand(len(k), -1))
        u = rng.uniform_from_bits(bits)
        scnt = (u[:, :, None] >= cdf[None]).sum(dim=2)  # inverse-CDF count
        s = torch.minimum(scnt, radix[None, :] - 1)
        w = torch.full((len(k),), 1.0 / n_samples, dtype=torch.float64, device=dev)
        _reduce_tile(s, radix, w, idx_tables, stage_durs, total_stages, n_servers,
                     e_succ, e_all)
    return e_succ, e_all


# ---------------------------------------------------------------------------
# The kernel's tables: a total order of the (job, stage) entries
# ---------------------------------------------------------------------------


class QueueTables(NamedTuple):
    """Every policy's ranked (job, stage) entries, ``L = N * M`` slots each;
    the slots past a policy's ranked entries hold duration 0 and links -1."""

    dur: torch.Tensor  # (P, L) float64: duration of the entry of rank r
    link: torch.Tensor  # (P, L, 2) int32: (rank of (j, s + 1) or -1, 2 j + (s == M_j - 1))
    rank_of: torch.Tensor  # (P, N, M) int32: rank of (j, s), or -1 when unranked
    q0: torch.Tensor  # (P, mask_words(N, M)) int64: bits of every job's stage-0 rank


def mask_words(n: int, m: int) -> int:
    """64-bit words of a mask over the ``n * m`` entries of a table."""
    return -(-(n * m) // 64)


def queue_tables(idx_tables, stage_durs, radix) -> QueueTables:
    """Rank each policy's seatable entries by (index, job, stage).

    An entry (j, s) with s < M_j is seatable when its index is neither
    +inf nor NaN (-inf is).  This is the lockstep dispatch's rule: a
    strict ``<`` in job order never seats a +inf or NaN index and breaks
    ties by the lower job; each job waits at one stage at a time, so the
    stage only orders a job's own entries.  -0.0 ranks as 0.0.  Runs on the
    tensors' device with no synchronisation.
    """
    p_pols, n, m = idx_tables.shape
    dev = idx_tables.device
    size = n * m
    stage = torch.arange(m, device=dev)
    radix = radix.to(torch.int64)
    seat = ((stage[None, :] < radix[:, None])[None]
            & ~torch.isnan(idx_tables) & (idx_tables != math.inf)).reshape(p_pols, size)
    key = torch.where(seat, idx_tables.reshape(p_pols, size) + 0.0, math.inf)
    order = torch.sort(key, dim=1, stable=True).indices  # flat j * m + s, ranked first
    ranked = seat.gather(1, order)
    ranks = torch.arange(size, device=dev).expand(p_pols, size)
    rank_of = torch.full_like(order, -1).scatter_(1, order, ranks)
    rank_of = torch.where(seat, rank_of, -1).reshape(p_pols, n, m)
    job, st = order // m, order % m
    nxt = torch.cat([rank_of, torch.full((p_pols, n, 1), -1, dtype=rank_of.dtype,
                                         device=dev)], dim=2).reshape(p_pols, -1)
    succ = nxt.gather(1, job * (m + 1) + st + 1)
    link = torch.stack([succ, 2 * job + (st == radix[job] - 1).to(torch.int64)], dim=2)
    link = torch.where(ranked[..., None], link, -1)
    dur = torch.where(ranked, stage_durs.reshape(-1)[order], 0.0)
    first = rank_of[:, :, 0]  # (P, N)
    bits = torch.where(first >= 0, torch.ones_like(first) << (first % 64), 0)
    q0 = torch.zeros((p_pols, mask_words(n, m)), dtype=torch.int64, device=dev)
    q0.scatter_add_(1, first.clamp(min=0) // 64, bits)  # distinct bits: the sum is the OR
    return QueueTables(dur, link.to(torch.int32).contiguous(), rank_of.to(torch.int32),
                       q0)


def digit_fields(radix) -> torch.Tensor:
    """(N, 2) int32 (lo, mask): job j's digit of the enumeration's packed
    mixed-radix index sits in bits [lo, lo + width) of a 64-bit word, width
    ``ceil(log2 M_j)``, job N - 1 lowest.  An index below 2**31 needs at
    most 40 bits (``ceil(log2 r) / log2 r`` is at most 1.29, at r = 5)."""
    radix = radix.to(torch.int64)
    width = ((1 << torch.arange(32, device=radix.device))[None, :] < radix[:, None]).sum(1)
    lo = width.flip(0).cumsum(0).flip(0) - width
    return torch.stack([lo, (1 << width) - 1], dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _scratch_per_thread(n: int, m: int, n_servers: int) -> int:
    """Scratch bytes a thread of the kernel needs: none on the register path
    (``REGISTER_WORDS`` mask words, ``REGISTER_SERVERS`` servers) or while a
    block's state fits ``SHARED_STATE_BYTES``."""
    words, w = mask_words(n, m), min(n_servers, n)
    state = STATE_BYTES * (words + w)
    if (words <= REGISTER_WORDS and w <= REGISTER_SERVERS) or \
            K.THREADS * state <= SHARED_STATE_BYTES:
        return 0
    return state


def _check_common(tab, stage_durs, idx_tables, radix, total_stages, n_servers):
    p_pols, n, m = idx_tables.shape
    dev = idx_tables.device
    K.check_tensor("idx_tables", idx_tables, torch.float64, (p_pols, n, m), dev)
    K.check_tensor("stage_durs", stage_durs, torch.float64, (n, m), dev)
    K.check_tensor("probs/cdf", tab, torch.float64, (n, m), dev)
    K.check_tensor("radix", radix, torch.int32, (n,), dev)
    if n_servers < 1:
        raise ValueError(f"n_servers must be >= 1; got {n_servers}")
    if total_stages < 0:
        raise ValueError(f"total_stages must be >= 0; got {total_stages}")
    return p_pols, n, m, dev


def dynamic_sojourn_enum(
    probs: torch.Tensor,  # (N, M) float64 padded stop probabilities
    stage_durs: torch.Tensor,  # (N, M) float64 padded per-stage increments
    idx_tables: torch.Tensor,  # (P, N, M) float64 index tables (+inf pad)
    strides: torch.Tensor,  # (N,) int32 mixed-radix strides
    radix: torch.Tensor,  # (N,) int32 stage counts
    k_total: int,
    total_stages: int,
    *,
    n_servers: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact (E[sojourn successful], E[sojourn all]) per policy, fused."""
    p_pols, n, m, dev = _check_common(
        probs, stage_durs, idx_tables, radix, total_stages, n_servers
    )
    K.check_tensor("strides", strides, torch.int32, (n,), dev)
    K.check_count("k_total", k_total)
    if dev.type == "cpu":
        return dynamic_sojourn_enum_torch(
            probs, stage_durs, idx_tables, strides, radix, k_total, total_stages,
            n_servers,
        )
    qt = queue_tables(idx_tables, stage_durs, radix)
    fields = digit_fields(radix)
    out = K.launch(
        "sojourn_dynamic", _SIGNATURES, "dynamic_enum_launch", dev, p_pols, k_total,
        (probs.data_ptr(), strides.data_ptr(), radix.data_ptr(), fields.data_ptr(),
         qt.dur.data_ptr(), qt.link.data_ptr(), qt.rank_of.data_ptr(), qt.q0.data_ptr(),
         p_pols, n, m, mask_words(n, m), k_total, total_stages, min(n_servers, n)),
        scratch_per_thread=_scratch_per_thread(n, m, n_servers),
    )
    launches["dynamic_sojourn_enum"] += 1
    profiling.count("ops.dynamic_entries", n * m)
    return out


def dynamic_sojourn_mc(
    cdf: torch.Tensor,  # (N, M) float64 stop-probability CDF
    stage_durs: torch.Tensor,  # (N, M) float64 padded per-stage increments
    idx_tables: torch.Tensor,  # (P, N, M) float64 index tables (+inf pad)
    radix: torch.Tensor,  # (N,) int32 stage counts
    seed: int,
    n_samples: int,
    total_stages: int,
    *,
    n_servers: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streamed-MC (E[sojourn successful], E[sojourn all]) per policy."""
    p_pols, n, m, dev = _check_common(
        cdf, stage_durs, idx_tables, radix, total_stages, n_servers
    )
    K.check_count("n_samples", n_samples)
    k0, k1 = rng.split_seed(seed)
    if dev.type == "cpu":
        return dynamic_sojourn_mc_torch(
            cdf, stage_durs, idx_tables, radix, seed, n_samples, total_stages,
            n_servers,
        )
    qt = queue_tables(idx_tables, stage_durs, radix)
    out = K.launch(
        "sojourn_dynamic", _SIGNATURES, "dynamic_mc_launch", dev, p_pols, n_samples,
        (cdf.data_ptr(), radix.data_ptr(), qt.dur.data_ptr(), qt.link.data_ptr(),
         qt.rank_of.data_ptr(), qt.q0.data_ptr(), p_pols, n, m, mask_words(n, m), n_samples,
         k0, k1, total_stages, min(n_servers, n)),
        scratch_per_thread=_scratch_per_thread(n, m, n_servers),
    )
    launches["dynamic_sojourn_mc"] += 1
    profiling.count("ops.dynamic_entries", n * m)
    return out


# ---------------------------------------------------------------------------
# Public op
# ---------------------------------------------------------------------------


def sojourn_eval_dynamic(
    probs: np.ndarray,  # (N, M) padded stop probabilities
    stage_durs: np.ndarray,  # (N, M) padded per-stage increments
    num_stages: np.ndarray,  # (N,) stage counts
    idx_tables: np.ndarray,  # (P, N, M) or (N, M) policy index tables
    *,
    samples: tuple[int, int] | None = None,  # (seed, n_samples) streamed MC
    n_servers: int = 1,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """(E[sojourn successful], E[sojourn all]) per policy, as NumPy (P,) arrays.

    With ``samples=None``, evaluates all ``K = prod(M_i)`` outcome
    combinations exactly without materializing them.  With
    ``samples=(seed, n_samples)``, estimates the same quantities by
    streaming Monte Carlo from the Threefry stream (bitwise the static
    op's stream and the ``ref.ref_mc_outcomes`` replay for the same
    seed).  ``n_servers=W`` evaluates W homogeneous servers.  All P
    policies go to one launch.  ``device=None`` is the CUDA card.

    When :mod:`repro_torch.obs.profiling` is enabled, each call is timed
    into a ``prof.sojourn_eval.dynamic.<mode>.<device>.seconds`` span,
    and inside it the kernel arguments into ``ops.args`` and the kernel
    wrapper's call into ``ops.launch``; the bytes of the inputs built on
    the host for the device add to the counter ``prof.ops.h2d_bytes``.
    """
    dev = resolve_device(device)
    mode = "mc" if samples is not None else "enum"
    with profiling.span(f"sojourn_eval.dynamic.{mode}.{dev.type}"):
        return _sojourn_eval_dynamic(
            probs, stage_durs, num_stages, idx_tables, samples, n_servers, dev
        )


def dynamic_kernel_args(probs, stage_durs, num_stages, idx_tables, device,
                        samples=None) -> tuple:
    """Positional arguments of :func:`dynamic_sojourn_enum` (``samples=None``)
    or :func:`dynamic_sojourn_mc` (``samples=(seed, n_samples)``) for the
    (P, N, M) index tables of a padded workload (``n_servers`` is a keyword
    of both)."""
    probs = np.asarray(probs, dtype=np.float64)
    num_stages = np.asarray(num_stages, dtype=np.int64)

    def f64(a):  # a copy: the cached workload tables are read-only
        return torch.tensor(np.asarray(a, dtype=np.float64), device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)

    total_stages = int(num_stages.sum())
    if samples is not None:
        cdf = np.cumsum(probs, axis=1)  # on the host, as the reference does
        tensors = (f64(cdf), f64(stage_durs), f64(idx_tables), i32(num_stages))
        scalars = (int(samples[0]), int(samples[1]), total_stages)
    else:
        tensors = (f64(probs), f64(stage_durs), f64(idx_tables),
                   i32(mixed_radix_strides(num_stages)), i32(num_stages))
        scalars = (math.prod(int(m) for m in num_stages), total_stages)
    profiling.count_bytes("ops.h2d_bytes", tensors)
    return (*tensors, *scalars)


def _sojourn_eval_dynamic(probs, stage_durs, num_stages, idx_tables, samples,
                          n_servers, dev):
    if n_servers < 1:
        raise ValueError(f"n_servers must be >= 1; got {n_servers}")
    n, m = np.shape(probs)
    idx_tables = np.asarray(idx_tables, dtype=np.float64)
    if idx_tables.ndim == 2:
        idx_tables = idx_tables[None]
    if idx_tables.shape[1:] != (n, m):
        raise ValueError(f"idx_tables must be (P, {n}, {m}); got {idx_tables.shape}")
    if samples is not None and int(samples[1]) <= 0:
        raise ValueError(f"n_samples must be positive; got {int(samples[1])}")
    launch = dynamic_sojourn_mc if samples is not None else dynamic_sojourn_enum
    with profiling.span("ops.args"):
        args = dynamic_kernel_args(probs, stage_durs, num_stages, idx_tables, dev, samples)
    with profiling.span("ops.launch"):
        es, ea = launch(*args, n_servers=n_servers)
    return es.cpu().numpy(), ea.cpu().numpy()
