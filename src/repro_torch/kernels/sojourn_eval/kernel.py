"""Static-order sojourn kernels: wrappers, launch counts and plain versions.

``sojourn_enum``, ``sojourn_mc`` and ``sojourn_outcomes`` replace the TPU
kernels of the same names in ``repro/kernels/sojourn_eval/kernel.py``;
their CUDA source is ``csrc/sojourn_static.cu`` (design notes there).
All take per-order inputs whose job axis is pre-permuted by the caller
(``ops.py``), so position ``pos`` is service position, and return
``(E[sojourn | successful], E[sojourn | all])`` per order as float64
tensors on the inputs' device.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a
CPU tensor runs the plain PyTorch version (``*_torch``), which tiles the
index range as the ``lax.scan`` paths of the JAX package do.
``launches`` counts kernel launches and nothing else; with
:mod:`repro_torch.obs.profiling` on, each ``sojourn_enum`` launch also adds
its suffix length L to the counter ``prof.ops.enum_suffix``.

The enumeration kernel walks each order's combinations in service order:
a thread decodes one prefix (the first N - L positions) and walks the
last L positions as an odometer from the prefix's state
(:func:`suffix_length` picks L).  It computes each combination's weight
product and completion times position by position in service order; its
plain version does the same sums with ``prod`` and ``cumsum`` over a tile
of combinations, so the two agree to rounding (1e-9 relative is the bar).

The Monte-Carlo kernel decodes stop stages in the integer domain: the
wrapper turns each position's CDF into uint32 thresholds on the card
(:func:`mc_tables`), which give the plain version's ``u >= cdf`` stages
bit for bit.  The outcome kernel reads the (K, N) table in the
evaluator's own layout, every order of a group against one read of each
row tile (:func:`outcomes_plan` picks the tile and the group).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sojourn_eval import rng
from repro_torch.obs import profiling

__all__ = [
    "THREADS",
    "launches",
    "sojourn_enum",
    "sojourn_mc",
    "sojourn_outcomes",
    "sojourn_enum_torch",
    "suffix_length",
    "enum_prefixes",
    "sojourn_mc_torch",
    "sojourn_outcomes_torch",
    "mc_tables",
    "OutcomesPlan",
    "outcomes_plan",
    "outcomes_smem_bytes",
]

#: Threads per block of the main kernels (``kThreads`` in csrc/common.cuh).
THREADS = 256
#: Blocks a launch aims for across all its orders (132 SMs on an H100).
TARGET_BLOCKS = 4096
#: Blocks of a launch whose threads each hold scratch in device memory
#: (the dynamic kernel when its state outgrows shared memory): four an SM,
#: so the scratch is that of the threads the card can run at once.
SCRATCH_BLOCKS = 4 * 132
#: Service positions a ``sojourn_enum`` thread walks after its prefix, at
#: most (``kMaxSuffix`` in the source: one template a length, 0 to 8).
MAX_SUFFIX = 8
#: Threads a ``sojourn_enum`` launch aims for, one an (order, prefix): two
#: 256-thread blocks an SM on 132 SMs take 67,584 at once.
ENUM_THREADS = 1 << 16
#: Index counts must fit the kernels' 32-bit decode / counter words.
MAX_COUNT = (1 << 31) - 1
#: Soft cap on bytes of per-tile intermediates in the plain versions.
PLAIN_TILE_BYTES = 256 << 20
#: Kernel launches per wrapper since the last reset (set to 0 to reset).
launches = {"sojourn_enum": 0, "sojourn_mc": 0, "sojourn_outcomes": 0}
#: Streaming multiprocessors of an H100 SXM: the outcome kernel's
#: persistent grid is a fixed number of blocks an SM, so a shape always
#: gets the same grid (and the same bits).
SM_COUNT = 132
#: Shared memory a block may opt into, and that an SM holds, on an H100
#: (227 and 228 KB); an SM keeps 1 KB of it for each resident block.
SMEM_BLOCK = 232448
SMEM_SM = 233472
#: Row tiles of the outcome kernel in flight a block (its mbarrier ring).
OUTCOMES_STAGES = 2
#: Rows a tile of the outcome kernel, largest first (two rows a thread).
OUTCOMES_ROWS = (256, 128, 64)
#: Threads of an outcome-kernel block, and of its blocks on an SM, at most
#: (``__launch_bounds__(256, 2)``: up to 128 registers a thread).
OUTCOMES_MAX_THREADS = 256
OUTCOMES_THREADS_PER_SM = 512
#: Stage counts the outcome kernel's transposed tile holds (16-bit byte
#: offsets of float64 sizes).
OUTCOMES_MAX_M = 1 << 13

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U = ctypes.c_uint
_SIGNATURES = {
    "sojourn_enum_launch": [_P, _P, _P, _P, _I, _I, _I, _LL, _I, _I, _P, _P, _P],
    "sojourn_mc_launch": [_P, _P, _P, _I, _I, _I, _LL, _U, _U, _I, _P, _P, _P],
    "sojourn_outcomes_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, _I, _I, _I, _I, _P,
                                _P, _P],
}


# ---------------------------------------------------------------------------
# Shared wrapper plumbing (also used by dynamic.py)
# ---------------------------------------------------------------------------


def check_tensor(name: str, t, dtype: torch.dtype, shape: tuple, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor; got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}; got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}; got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_count(name: str, count: int) -> None:
    if not 0 < count <= MAX_COUNT:
        raise ValueError(f"{name} must be in [1, 2**31); got {count}")


def blocks_per_order(count: int, n_orders: int, target: int = TARGET_BLOCKS) -> int:
    """Blocks of ``THREADS`` per order: enough to fill the card (``target``
    blocks in all), at most one index per thread."""
    return max(1, min(-(-count // THREADS), -(-target // n_orders)))


def launch(stem, signatures, entry, device, n_orders, count, args, rows=None,
           scratch_per_thread=None, nblk=None) -> tuple:
    """Allocate the partials and the output on ``device``, call the C
    entry point ``entry`` on the current stream, raise on a CUDA error
    and return ``(e_succ, e_all)``.  No synchronisation.  ``rows`` is the
    number of grid rows sharing the blocks (default: one per order);
    ``nblk``, when given, the blocks of each order's partials.

    With ``scratch_per_thread`` (bytes), the entry point takes a scratch
    pointer after ``args``: NULL for 0, else a buffer of that many bytes
    for each thread of a grid cut to ``SCRATCH_BLOCKS`` blocks.  Raises
    ``MemoryError`` naming the bytes when the card cannot hold it."""
    if device.type != "cuda":
        raise ValueError(f"{entry} launches on a CUDA device; got {device}")
    lib = _build.library(stem, signatures)
    if nblk is None:
        nblk = blocks_per_order(count, rows or n_orders,
                                SCRATCH_BLOCKS if scratch_per_thread else TARGET_BLOCKS)
    extra = () if scratch_per_thread is None else (None,)  # NULL: no scratch
    with torch.cuda.device(device):
        if scratch_per_thread:
            threads = (rows or n_orders) * nblk * THREADS
            nbytes = threads * scratch_per_thread
            try:  # held until the launch, so that no later buffer takes its place
                scratch = torch.empty(nbytes, dtype=torch.uint8, device=device)
            except torch.cuda.OutOfMemoryError as err:
                raise MemoryError(f"{entry} needs {nbytes} bytes of scratch on {device}: "
                                  f"{scratch_per_thread} for each of {threads} threads") from err
            extra = (scratch.data_ptr(),)
        partials = torch.empty((n_orders, nblk, 2), dtype=torch.float64, device=device)
        out = torch.empty((2, n_orders), dtype=torch.float64, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, entry)(
            *args, *extra, nblk, partials.data_ptr(), out.data_ptr(), stream
        )
    _build.check(lib, code, entry)
    return out[0], out[1]


def _plain_tile(width: int) -> int:
    """Indices per tile of a plain version whose lanes hold ``width`` values."""
    return max(1, min(1 << 15, PLAIN_TILE_BYTES // (64 * max(width, 1))))


def _permuted_gather(table_p: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """table_p (P, N, M) gathered at stop stages s (T, P, N) -> (T, P, N)."""
    p_orders, n, m = table_p.shape
    base = (torch.arange(p_orders, device=s.device)[:, None] * n
            + torch.arange(n, device=s.device)[None, :]) * m
    return table_p.reshape(-1)[base[None] + s]


def _accumulate(d, succ, w, e_succ, e_all) -> None:
    """Eqs. (7)-(9) over one tile: d, succ (T, P, N) in service order, w (T, P)."""
    n = d.shape[2]
    t = torch.cumsum(d, dim=2)  # completion times
    cnt = succ.sum(dim=2)
    tot = (t * succ).sum(dim=2)
    mean = torch.where(cnt > 0, tot / cnt.clamp(min=1), 0.0)
    e_succ += (w * mean).sum(dim=0)
    e_all += (w * (t.sum(dim=2) / n)).sum(dim=0)


# ---------------------------------------------------------------------------
# Exact enumeration
# ---------------------------------------------------------------------------


def enum_prefixes(n: int, suffix: int, k_total: int) -> int:
    """Prefixes of an order whose last ``suffix`` of ``n`` positions are
    walked: ``k_total ** ((n - suffix) / n)``, exact when every job has the
    same stage count and an estimate otherwise (the kernel counts each
    order's own and walks them all, whatever the grid)."""
    return max(1, round(k_total ** ((n - suffix) / n)))


def suffix_length(n: int, n_orders: int, k_total: int) -> int:
    """L for :func:`sojourn_enum`: the longest suffix, at most
    ``min(n, MAX_SUFFIX)``, whose prefixes over all ``n_orders`` orders
    still give ``ENUM_THREADS`` threads, so that the launch fills the
    card while each thread shares its prefix over as many combinations as
    it can.  0 (a thread a combination) when even that falls short: the
    launch is small.  At N = 26, M = 2, P = 1 it is 8; at N = 8, M = 3,
    P = 512 (the OPTIMAL search's batches) 3; an empty prefix (L = N)
    takes P >= ENUM_THREADS at N <= MAX_SUFFIX."""
    for length in range(min(n, MAX_SUFFIX), 0, -1):
        if n_orders * k_total ** ((n - length) / n) >= ENUM_THREADS * (1 - 1e-12):
            return length
    return 0


def _radix_mismatch(strides_p, radix_p, k_total: int) -> torch.Tensor:
    """(P,) bool: the orders whose ``strides_p`` are not the mixed-radix
    strides of their ``radix_p`` in any job order, or whose combinations do
    not number ``k_total``.  Sorted by stride (a stage count of 1 first among
    equal ones), valid strides run 1, M, M M', ...: each is the product of
    the stage counts sorted before it."""
    radix = radix_p.to(torch.int64)
    strides = strides_p.to(torch.int64)
    order = torch.sort(2 * strides + (radix != 1), dim=1, stable=True).indices
    r = torch.gather(radix, 1, order).to(torch.float64)  # exact to 2^53
    before = torch.cumprod(torch.cat([torch.ones_like(r[:, :1]), r[:, :-1]], dim=1), dim=1)
    wrong = (before != torch.gather(strides, 1, order).to(torch.float64)).any(dim=1)
    return wrong | (r.prod(dim=1) != k_total)


def sojourn_enum_torch(sizes_p, probs_p, strides_p, radix_p, k_total: int):
    """Plain version of :func:`sojourn_enum` on any device."""
    p_orders, n, _ = sizes_p.shape
    dev = sizes_p.device
    strides = strides_p.to(torch.int64)[None]
    radix = radix_p.to(torch.int64)[None]
    e_succ = torch.zeros(p_orders, dtype=torch.float64, device=dev)
    e_all = torch.zeros(p_orders, dtype=torch.float64, device=dev)
    tile = _plain_tile(p_orders * n)
    for lo in range(0, k_total, tile):
        k = torch.arange(lo, min(lo + tile, k_total), device=dev)
        s = (k[:, None, None] // strides) % radix  # (T, P, N) decode
        w = _permuted_gather(probs_p, s).prod(dim=2)  # Eq. (8)
        _accumulate(_permuted_gather(sizes_p, s), s == radix - 1, w, e_succ, e_all)
    bad = _radix_mismatch(strides_p, radix_p, k_total)
    return e_succ.masked_fill(bad, float("nan")), e_all.masked_fill(bad, float("nan"))


def sojourn_enum(
    sizes_p: torch.Tensor,  # (P, N, M) float64 per-order permuted cumulative sizes
    probs_p: torch.Tensor,  # (P, N, M) float64 per-order permuted stop probabilities
    strides_p: torch.Tensor,  # (P, N) int32 permuted mixed-radix strides
    radix_p: torch.Tensor,  # (P, N) int32 permuted stage counts
    k_total: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact (E[sojourn successful], E[sojourn all]) per order, fused.

    The kernel walks the last :func:`suffix_length` service positions of
    each combination from its thread's prefix.  ``strides_p`` must be each
    order's mixed-radix strides of ``radix_p`` in some job order (the
    caller's, permuted) and ``k_total`` the product of its ``radix_p``: an
    order for which either is not so gives NaN, on either device."""
    p_orders, n, m = sizes_p.shape
    dev = sizes_p.device
    check_tensor("sizes_p", sizes_p, torch.float64, (p_orders, n, m), dev)
    check_tensor("probs_p", probs_p, torch.float64, (p_orders, n, m), dev)
    check_tensor("strides_p", strides_p, torch.int32, (p_orders, n), dev)
    check_tensor("radix_p", radix_p, torch.int32, (p_orders, n), dev)
    check_count("k_total", k_total)
    if dev.type == "cpu":
        return sojourn_enum_torch(sizes_p, probs_p, strides_p, radix_p, k_total)
    suffix = suffix_length(n, p_orders, k_total)
    out = launch(
        "sojourn_static", _SIGNATURES, "sojourn_enum_launch", dev, p_orders,
        enum_prefixes(n, suffix, k_total),
        (sizes_p.data_ptr(), probs_p.data_ptr(), strides_p.data_ptr(), radix_p.data_ptr(),
         p_orders, n, m, k_total, suffix),
    )
    launches["sojourn_enum"] += 1
    profiling.count("ops.enum_suffix", suffix)
    return out


# ---------------------------------------------------------------------------
# Streamed Monte Carlo
# ---------------------------------------------------------------------------


def sojourn_mc_torch(sizes_p, cdf_p, radix_p, orders, seed: int, n_samples: int):
    """Plain version of :func:`sojourn_mc` on any device."""
    p_orders, n, _ = sizes_p.shape
    dev = sizes_p.device
    key = rng.split_seed(seed)
    radix = radix_p.to(torch.int64)[None]
    orders = orders.to(torch.int64)
    e_succ = torch.zeros(p_orders, dtype=torch.float64, device=dev)
    e_all = torch.zeros(p_orders, dtype=torch.float64, device=dev)
    job_ids = torch.arange(n, device=dev)[None, :]
    tile = _plain_tile(p_orders * n)
    for lo in range(0, n_samples, tile):
        k = torch.arange(lo, min(lo + tile, n_samples), device=dev)
        # the stream is keyed by ORIGINAL job id: draw per job, then permute
        bits, _ = rng.threefry2x32_torch(key, k[:, None].expand(-1, n), job_ids.expand(len(k), -1))
        u = rng.uniform_from_bits(bits)[:, orders]  # (T, P, N)
        scnt = (u[..., None] >= cdf_p[None]).sum(dim=3)  # inverse-CDF count
        s = torch.minimum(scnt, radix - 1)
        w = torch.full((len(k), p_orders), 1.0 / n_samples, dtype=torch.float64, device=dev)
        _accumulate(_permuted_gather(sizes_p, s), s == radix - 1, w, e_succ, e_all)
    return e_succ, e_all


def _as_int32_bits(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) as the int32 tensor of the same 32 bits."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def mc_tables(cdf_p: torch.Tensor, radix_p: torch.Tensor, orders: torch.Tensor,
              k1: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The position tables of the Monte-Carlo kernel, made on the tensors'
    device: ``recs`` (P, N, 4) int32 ``{job + k1, s0, r - 1, t_0}`` and
    ``extra`` (P, N, max(M - 2, 0)) int32, the thresholds ``t_1 ..``.

    The uniform is ``bits * 2**-32`` exactly, so ``u >= cdf`` holds exactly
    when ``bits >= ceil(cdf * 2**32)``: a key of ``-1`` where that is 0 or
    less (always; -inf too), of ``2**32`` where it is past ``2**32 - 1``
    (never; NaN and +inf too), else the ceiling.  The stop stage is the
    count of passed keys clamped to ``r - 1``, which only the ``min(r - 1,
    M)`` smallest keys decide; sorted, the passed ones are a prefix.  So
    ``s0`` counts the always-passing ones among them and each slot holds a
    further one's key minus one (``2**32 - 1``, never, past the first ``r -
    1``), and the kernel's ``s0 + (bits > t_0) + (bits > t_1) + ...`` (uint32
    compares) is the plain version's stage for every ``bits``."""
    p_orders, n, m = cdf_p.shape
    x = torch.ceil(cdf_p * 2.0**32)
    key = torch.where(x <= 0, -1.0, torch.where(x < 2.0**32, x, 2.0**32)).to(torch.int64)
    key = torch.sort(key, dim=2).values
    r1 = radix_p.to(torch.int64) - 1
    lim = torch.clamp(r1, max=m)[..., None]  # the keys that decide the stage
    s0 = torch.minimum((key < 0).sum(dim=2, keepdim=True), lim)
    idx = s0 + torch.arange(max(m - 1, 1), device=cdf_p.device)
    slot = torch.gather(key, 2, idx.clamp(max=m - 1)) - 1
    slot = torch.where(idx < lim, slot, (1 << 32) - 1)
    x1 = (orders.to(torch.int64) + k1) & 0xFFFFFFFF
    recs = torch.cat([x1[..., None], s0, r1[..., None], slot[..., :1]], dim=2)
    return _as_int32_bits(recs), _as_int32_bits(slot[..., 1:]).contiguous()


def sojourn_mc(
    sizes_p: torch.Tensor,  # (P, N, M) float64 per-order permuted cumulative sizes
    cdf_p: torch.Tensor,  # (P, N, M) float64 per-order permuted stop-probability CDF
    radix_p: torch.Tensor,  # (P, N) int32 permuted stage counts
    orders: torch.Tensor,  # (P, N) int32 original job ids by position
    seed: int,
    n_samples: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streamed-MC (E[sojourn successful], E[sojourn all]) per order.  On the
    card the CDF becomes uint32 thresholds once a call (:func:`mc_tables`)."""
    p_orders, n, m = sizes_p.shape
    dev = sizes_p.device
    check_tensor("sizes_p", sizes_p, torch.float64, (p_orders, n, m), dev)
    check_tensor("cdf_p", cdf_p, torch.float64, (p_orders, n, m), dev)
    check_tensor("radix_p", radix_p, torch.int32, (p_orders, n), dev)
    check_tensor("orders", orders, torch.int32, (p_orders, n), dev)
    check_count("n_samples", n_samples)
    k0, k1 = rng.split_seed(seed)
    if dev.type == "cpu":
        return sojourn_mc_torch(sizes_p, cdf_p, radix_p, orders, seed, n_samples)
    recs, extra = mc_tables(cdf_p, radix_p, orders, k1)
    out = launch(
        "sojourn_static", _SIGNATURES, "sojourn_mc_launch", dev, p_orders, n_samples,
        (sizes_p.data_ptr(), recs.data_ptr(), extra.data_ptr(), p_orders, n, m, n_samples,
         k0, k1),
    )
    launches["sojourn_mc"] += 1
    return out


# ---------------------------------------------------------------------------
# Explicit outcome tables
# ---------------------------------------------------------------------------


def sojourn_outcomes_torch(sizes_p, radix_p, orders, outcomes, weights):
    """Plain version of :func:`sojourn_outcomes` on any device."""
    p_orders, n, _ = sizes_p.shape
    k_total = weights.shape[0]
    radix = radix_p.to(torch.int64)[None]
    orders = orders.to(torch.int64)
    e_succ = torch.zeros(p_orders, dtype=torch.float64, device=sizes_p.device)
    e_all = torch.zeros(p_orders, dtype=torch.float64, device=sizes_p.device)
    tile = _plain_tile(p_orders * n)
    for lo in range(0, k_total, tile):
        hi = min(lo + tile, k_total)
        s = outcomes[lo:hi].to(torch.int64)[:, orders]  # (T, P, N) service order
        w = weights[lo:hi, None].expand(-1, p_orders)
        _accumulate(_permuted_gather(sizes_p, s), s == radix - 1, w, e_succ, e_all)
    return e_succ, e_all


def outcomes_smem_bytes(n: int, m: int, rows: int, stages: int, group: int,
                        split: int) -> int:
    """Shared-memory bytes of the outcome kernel (``OutLayout`` in the
    source): the ring's barriers, ``stages`` tiles of ``rows`` table rows and
    weights, the tile's weights, the group's sizes, its warps' sums and its
    (job column, r - 1) pairs, and the tile transposed to (N, rows + 2)
    16-bit byte offsets of the stop stages' sizes."""
    up16 = lambda b: (b + 15) // 16 * 16  # noqa: E731
    warps = rows // 2 // 32 * split
    head = 32 + stages * (rows * n * 4 + rows * 8) + rows * 8
    head += group * n * m * 8 + group * warps * 16 + group * n * 8
    return up16(up16(head) + n * (rows // 2 + 1) * 4)


class OutcomesPlan(NamedTuple):
    """How the outcome kernel walks a table: ``rows`` a tile (0: the direct
    kernel, which reads everything through L1), ``stages`` tiles in flight,
    ``group`` orders against one read of the table, ``split`` sets of
    ``rows / 2`` threads sharing out a group's orders, ``blocks_per_sm``."""

    rows: int
    stages: int
    group: int
    split: int
    blocks_per_sm: int


def outcomes_plan(n: int, m: int, n_orders: int) -> OutcomesPlan:
    """The largest tile (two blocks an SM if it can, else one) whose ring,
    transposed copy and one order's tables fit; as many orders in a group
    as the rest holds, shared out among up to ``OUTCOMES_MAX_THREADS / (rows
    / 2)`` sets of threads (at most one set an order); then as many blocks
    an SM as shared memory and ``OUTCOMES_THREADS_PER_SM`` take.  At N = 27,
    M = 2: 256 rows, up to 51 orders in a group (phase 4's 17 in one) and 2
    sets; at N = 192: 64 rows, one block an SM and up to 22 orders; from
    345 jobs (M = 2) the direct kernel, which also takes M past
    ``OUTCOMES_MAX_M``."""
    if m > OUTCOMES_MAX_M:
        return OutcomesPlan(0, 0, n_orders, 0, 0)
    stages = OUTCOMES_STAGES
    for budget, per_sm in (((SMEM_SM - 2048) // 2, 2), (SMEM_BLOCK - 1024, 1)):
        for rows in OUTCOMES_ROWS:
            split = max(1, min(OUTCOMES_MAX_THREADS // (rows // 2), n_orders))
            if outcomes_smem_bytes(n, m, rows, stages, 1, split) > budget:
                continue
            per_order = n * m * 8 + rows // 64 * split * 16 + n * 8
            fixed = outcomes_smem_bytes(n, m, rows, stages, 0, split)
            group = max(1, min(n_orders, (budget - fixed) // per_order))
            while outcomes_smem_bytes(n, m, rows, stages, group, split) > budget:
                group -= 1  # the 16-byte rounding, at most once or twice
            split = min(split, group)
            used = outcomes_smem_bytes(n, m, rows, stages, group, split) + 1024
            per_sm = max(1, min(SMEM_SM // used, OUTCOMES_THREADS_PER_SM // (rows // 2 * split)))
            return OutcomesPlan(rows, stages, group, split, per_sm)
    return OutcomesPlan(0, 0, n_orders, 0, 0)


def sojourn_outcomes(
    sizes_p: torch.Tensor,  # (P, N, M) float64 per-order permuted cumulative sizes
    radix_p: torch.Tensor,  # (P, N) int32 permuted stage counts
    orders: torch.Tensor,  # (P, N) int32 original job ids by position
    outcomes: torch.Tensor,  # (K, N) int32 stop stages, row-major, in [0, M_i)
    weights: torch.Tensor,  # (K,) float64 combination weights
) -> tuple[torch.Tensor, torch.Tensor]:
    """(E[sojourn successful], E[sojourn all]) per order over an explicit
    outcome table, fused.  On the card one launch evaluates a group of
    orders (:func:`outcomes_plan`) against one read of the table; more
    orders than a group make one launch a group."""
    p_orders, n, m = sizes_p.shape
    dev = sizes_p.device
    k_total = weights.shape[0] if isinstance(weights, torch.Tensor) else -1
    check_tensor("sizes_p", sizes_p, torch.float64, (p_orders, n, m), dev)
    check_tensor("radix_p", radix_p, torch.int32, (p_orders, n), dev)
    check_tensor("orders", orders, torch.int32, (p_orders, n), dev)
    check_tensor("weights", weights, torch.float64, (k_total,), dev)
    check_tensor("outcomes", outcomes, torch.int32, (k_total, n), dev)
    check_count("K", k_total)
    if dev.type == "cpu":
        return sojourn_outcomes_torch(sizes_p, radix_p, orders, outcomes, weights)
    plan = outcomes_plan(n, m, p_orders)
    parts = []
    for lo in range(0, p_orders, plan.group):
        hi = min(lo + plan.group, p_orders)
        if plan.rows:
            nblk = min(-(-k_total // plan.rows), plan.blocks_per_sm * SM_COUNT)
        else:
            nblk = blocks_per_order(k_total, hi - lo)
        parts.append(launch(
            "sojourn_static", _SIGNATURES, "sojourn_outcomes_launch", dev, hi - lo, k_total,
            (sizes_p[lo:hi].data_ptr(), radix_p[lo:hi].data_ptr(), orders[lo:hi].data_ptr(),
             outcomes.data_ptr(), weights.data_ptr(), hi - lo, n, m, k_total, plan.rows,
             plan.stages, plan.split),
            nblk=nblk,
        ))
        launches["sojourn_outcomes"] += 1
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
