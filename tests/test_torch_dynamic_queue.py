"""The dynamic sojourn kernel's ranked queue, modelled on the CPU.

``csrc/sojourn_dynamic.cu`` simulates the lockstep W-server policy on a
total order of the (job, stage) entries that ``dynamic.queue_tables``
builds: a queue bitmask Q, a stop bitmask S and W server slots (its
source note).  A CUDA kernel does not run here, so:

* ``queue_tables`` is checked on crafted tables: ties between jobs go to
  the lower job, +inf and NaN entries get no rank while -inf entries do,
  -0.0 ties 0.0, stages past M_j of a ragged group are unranked; the
  successors, success flags, durations and stage-0 mask words;
* ``digit_fields`` and the kernel's carry advance (modelled below) give
  the mixed-radix decode of every index;
* ``_model`` is the kernel's step loop in plain Python on those tables.
  For every combination of small groups (N <= 8, M = 2-4; W = 1, 2, 3
  and W >= N; SR, SERPT and RANK tables, a RANK table with a +inf row,
  forced ties, a ragged group) it gives per-combination ``(tot, tsum,
  cnt)`` equal, as float64 values, to the plain version's
  ``_sim_tile_torch``, and Eq. (7)-(9) totals within 1e-9 of the
  reference's ``sojourn_eval_dynamic`` (its XLA path under
  ``jax.enable_x64``, as ``tests/test_torch_dynamic.py`` runs it).

A -inf index is seated by the kernels (and by the reference's Pallas
kernel) but not by the XLA path, which seats only a finite minimum; no
policy table holds one, so here the model is held to the plain version on
finite and +inf tables only.  P4 is repaired: the plain version now seats
as the kernels do, and ``test_torch_dynamic_nonfinite.py`` holds it to
the model and to the Pallas kernel on NaN and -inf tables.
"""

import dataclasses
import math
from itertools import product

import jax
import numpy as np
import pytest
import torch

from repro.core import jobs as ref_jobs
from repro.kernels.sojourn_eval import dynamic as ref_dynamic
from repro_torch.core import policies
from repro_torch.core.jobs import from_reference
from repro_torch.kernels.sojourn_eval import dynamic as D
from repro_torch.kernels.sojourn_eval.ref import mixed_radix_strides

RTOL = 1e-9
INF, NAN = math.inf, math.nan


# ---------------------------------------------------------------------------
# The kernel's step loop and digit advance, in plain Python
# ---------------------------------------------------------------------------


def _tables(idx_table, durs, radix):
    qt = D.queue_tables(torch.tensor(idx_table[None], dtype=torch.float64),
                        torch.tensor(durs, dtype=torch.float64),
                        torch.tensor(radix, dtype=torch.int32))
    q0 = sum((int(w) & (2**64 - 1)) << (64 * i) for i, w in enumerate(qt.q0[0].tolist()))
    return qt.dur[0].tolist(), qt.link[0].tolist(), qt.rank_of[0].tolist(), q0


def _model(stops, tables, n_servers, total_stages):
    """(tot, tsum, cnt) of one combination (decoded stop stages ``stops``),
    as the kernel computes them: Q and S as Python ints, W slots."""
    dur, link, rank_of, q = tables
    s_mask = 0
    for j, s in enumerate(stops):
        if rank_of[j][s] >= 0:
            s_mask |= 1 << rank_of[j][s]
    slots = [None] * min(n_servers, len(stops))  # (busy_until, job, rank)

    def pop_queue():
        nonlocal q
        r = (q & -q).bit_length() - 1
        q &= q - 1
        return r

    clock = tot = tsum = 0.0
    cnt = 0
    for i in range(len(slots)):  # t = 0
        if not q:
            break
        r = pop_queue()
        slots[i] = (clock + dur[r], link[r][1] >> 1, r)
    for _ in range(total_stages):
        running = [(x[0], x[1], c) for c, x in enumerate(slots) if x is not None]
        if not running or not min(running)[0] < INF:
            break
        b, _, c = min(running)  # the least (busy_until, job)
        r = slots[c][2]
        slots[c] = None
        clock = b
        succ, job_flag = link[r]
        if s_mask >> r & 1:
            tsum += clock
            if job_flag & 1:
                tot += clock
                cnt += 1
        elif succ >= 0:
            q |= 1 << succ
        if q:
            r2 = pop_queue()
            slots[c] = (clock + dur[r2], link[r2][1] >> 1, r2)
    return tot, tsum, cnt


def _unpack(x, fields):
    return [(x >> lo) & mask for lo, mask in fields]


def _advance(x, y, fields, radix):
    """x + y in packed mixed radix (the kernel's ``advance_digits``): carries
    from y's least significant non-zero digit up, stopping once no carry is
    left above its most significant one."""
    nonzero = [j for j, d in enumerate(_unpack(y, fields)) if d]
    jlo, jtop = (nonzero[-1], nonzero[0]) if nonzero else (-1, len(radix))
    carry = 0
    for j in range(jlo, -1, -1):
        if j < jtop and not carry:
            break
        lo, mask = fields[j]
        d = ((x >> lo) & mask) + ((y >> lo) & mask) + carry
        carry = int(d >= radix[j])
        d -= carry * radix[j]
        x = (x & ~(mask << lo)) | (d << lo)
    return x


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------


def _jobs(kind, n, m, seed):
    ref = ref_jobs.generate_workload(np.random.default_rng(seed), n, m, 1)
    if kind == "ties":  # identical jobs: equal SR and SERPT indices
        ref[1] = dataclasses.replace(ref[0], job_id=ref[1].job_id)
        ref[3] = dataclasses.replace(ref[2], job_id=ref[3].job_id)
    elif kind == "inf":  # a job that never succeeds: rank index +inf (R2)
        ref[2] = ref_jobs.JobSpec(sizes=[1.0, 3.0], probs=[1.0, 0.0], job_id=ref[2].job_id)
    elif kind == "ragged":
        ref = [ref_jobs.JobSpec(sizes=[1.0], probs=[1.0], job_id=0),
               ref_jobs.JobSpec(sizes=[0.5, 2.0, 4.0, 4.5], probs=[0.2, 0.3, 0.1, 0.4], job_id=1),
               ref_jobs.JobSpec(sizes=[1.5, 3.0], probs=[0.6, 0.4], job_id=2),
               ref_jobs.JobSpec(sizes=[0.2, 0.9, 1.7], probs=[0.1, 0.5, 0.4], job_id=3),
               ref_jobs.JobSpec(sizes=[1.5, 2.0], probs=[0.5, 0.5], job_id=4)]
    return from_reference(ref)


#: (policy, workload kind, N, M, seed); "floor" rounds the table down to force
#: ties across jobs and stages.
CASES = [
    ("sr", "plain", 8, 2, 1),
    ("serpt", "plain", 6, 3, 2),
    ("rank", "plain", 5, 4, 3),
    ("sr", "ties", 6, 2, 4),
    ("serpt", "ties", 5, 3, 5),
    ("rank", "inf", 6, 2, 6),
    ("serpt", "floor", 6, 3, 7),
    ("sr", "ragged", 5, 4, 0),
]
SERVERS = (1, 2, 3, "n")


def _case(policy, kind, n, m, seed):
    jobs = _jobs(kind, n, m, seed)
    _, probs, num_stages = policies.padded_arrays(jobs)
    table = policies.index_table(jobs, policy)
    if kind == "floor":
        table = np.floor(table)
    if kind == "inf":
        assert np.isinf(table).any()
    return probs, policies.stage_durations(jobs), num_stages, np.asarray(table, np.float64)


def _combinations(num_stages):
    return np.array(list(product(*(range(int(r)) for r in num_stages))), dtype=np.int64)


def _servers(w, n):
    return n + 2 if w == "n" else w


# ---------------------------------------------------------------------------
# queue_tables and digit_fields
# ---------------------------------------------------------------------------


def test_queue_tables_ranks_ties_infinities_and_ragged_stages():
    radix = [3, 2, 3, 1]
    pad = 0.5  # finite, past M_j: never ranked
    first = [[2.0, 1.0, 5.0], [1.0, INF, pad], [-INF, NAN, 1.0], [2.0, pad, pad]]
    zeros = [[0.0, 0.0, 0.0], [-0.0, -1.0, pad], [0.0, 0.0, 0.0], [-0.0, pad, pad]]
    durs = np.arange(12, dtype=np.float64).reshape(4, 3) + 0.25
    qt = D.queue_tables(torch.tensor([first, zeros], dtype=torch.float64),
                        torch.tensor(durs), torch.tensor(radix, dtype=torch.int32))
    # by (index, job, stage): (2,0) -inf; (0,1), (1,0), (2,2) at 1.0; (0,0), (3,0) at 2.0; (0,2)
    assert qt.rank_of[0].tolist() == [[4, 1, 6], [2, -1, -1], [0, -1, 3], [5, -1, -1]]
    assert qt.link[0].tolist() == [[-1, 4], [6, 0], [-1, 2], [-1, 5], [1, 0], [-1, 7],
                                   [-1, 1]] + [[-1, -1]] * 5
    assert qt.dur[0].tolist() == [durs[2, 0], durs[0, 1], durs[1, 0], durs[2, 2], durs[0, 0],
                                  durs[3, 0], durs[0, 2]] + [0.0] * 5
    # -1.0 first, then the zeros (-0.0 among them) in (job, stage) order
    assert qt.rank_of[1].tolist() == [[1, 2, 3], [4, 0, -1], [5, 6, 7], [8, -1, -1]]
    assert qt.link[1][:9, 0].tolist() == [-1, 2, 3, -1, 0, 6, 7, -1, -1]
    assert qt.link[1][:9, 1].tolist() == [3, 0, 0, 1, 2, 4, 4, 5, 7]
    assert qt.q0.tolist() == [[1 | 4 | 16 | 32], [2 | 16 | 32 | 256]]
    assert (qt.dur.dtype, qt.link.dtype, qt.rank_of.dtype, qt.q0.dtype) == (
        torch.float64, torch.int32, torch.int32, torch.int64)


@pytest.mark.parametrize("n,m", [(32, 2), (33, 2), (13, 5), (1, 1)])
def test_queue_tables_mask_words(n, m):
    """One bit a ranked entry; a rank of 63 sets the word's sign bit."""
    table = np.random.default_rng(n).permutation(n * m).reshape(n, m).astype(np.float64)
    radix = np.full(n, m)
    qt = D.queue_tables(torch.tensor(table[None]), torch.ones((n, m), dtype=torch.float64),
                        torch.tensor(radix, dtype=torch.int32))
    assert qt.q0.shape == (1, D.mask_words(n, m)) == (1, -(-(n * m) // 64))
    want = sum(1 << int(table[j, 0]) for j in range(n))  # the table is its own rank
    got = sum((int(w) & (2**64 - 1)) << (64 * i) for i, w in enumerate(qt.q0[0].tolist()))
    assert got == want
    assert qt.rank_of[0].tolist() == table.astype(int).tolist()


@pytest.mark.parametrize("radix", [[2] * 26, [3, 2, 5, 1, 4, 1, 7], [1, 1, 1], [5] * 13,
                                   [2**30, 1]])
def test_digit_advance_is_the_mixed_radix_decode(radix):
    """Packing the digits of k and adding the stride's with carries gives
    the digits of k + stride, for each thread's walk of a grid."""
    fields = D.digit_fields(torch.tensor(radix, dtype=torch.int32)).tolist()
    widths = [mask.bit_length() for _, mask in fields]
    assert [lo for lo, _ in fields] == [sum(widths[j + 1:]) for j in range(len(radix))]
    assert all(mask + 1 >= r > (mask + 1) // 2 or r == 1 for (_, mask), r in zip(fields, radix))
    assert sum(widths) <= 40
    strides = mixed_radix_strides(np.array(radix))
    count = math.prod(radix)

    def pack(k):
        return sum(((k // int(s)) % r) << lo for s, r, (lo, _) in zip(strides, radix, fields))

    for step in (1, 3, 256 * 7, 1 << 20, count + 5):
        for start in (0, 1, 255, count // 3):
            if start >= count:
                continue
            x, y = pack(start), pack(step)
            for k in range(start, min(count, start + 40 * step), step):
                assert _unpack(x, fields) == _unpack(pack(k), fields)
                x = _advance(x, y, fields, radix)


# ---------------------------------------------------------------------------
# The model against the plain version and against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", SERVERS)
@pytest.mark.parametrize("policy,kind,n,m,seed", CASES)
def test_model_matches_plain_per_combination(policy, kind, n, m, seed, w):
    probs, durs, num_stages, table = _case(policy, kind, n, m, seed)
    n_servers, total = _servers(w, n), int(num_stages.sum())
    s = _combinations(num_stages)
    succ = s == num_stages[None, :] - 1
    tot, tsum, cnt = D._sim_tile_torch(torch.tensor(s), torch.tensor(succ), torch.tensor(table),
                                       torch.tensor(durs), total_stages=total,
                                       n_servers=n_servers)
    tables = _tables(table, durs, num_stages)
    got = [_model(row, tables, n_servers, total) for row in s.tolist()]
    assert [g[0] for g in got] == tot.tolist()
    assert [g[1] for g in got] == tsum.tolist()
    assert [g[2] for g in got] == cnt.tolist()


@pytest.mark.parametrize("w", SERVERS)
@pytest.mark.parametrize("policy,kind,n,m,seed", CASES)
def test_model_totals_match_reference(policy, kind, n, m, seed, w):
    probs, durs, num_stages, table = _case(policy, kind, n, m, seed)
    n_servers, total = _servers(w, n), int(num_stages.sum())
    tables = _tables(table, durs, num_stages)
    e_succ = e_all = 0.0
    for row in _combinations(num_stages).tolist():
        weight = math.prod(probs[j, s] for j, s in enumerate(row))
        tot, tsum, cnt = _model(row, tables, n_servers, total)
        e_succ += weight * (tot / cnt if cnt else 0.0)
        e_all += weight * tsum / n
    with jax.enable_x64(True):
        want = ref_dynamic.sojourn_eval_dynamic(probs, durs, num_stages, table,
                                                n_servers=n_servers, impl="xla")
    np.testing.assert_allclose([e_succ, e_all], [want[0][0], want[1][0]], rtol=RTOL, atol=0)
