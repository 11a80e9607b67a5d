"""The ``sojourn_enum`` kernel's prefix/suffix walk, modelled on the CPU.

``csrc/sojourn_static.cu``'s enumeration gives each thread one prefix of
service positions (its first N - L), decoded once, and walks the last L
positions as an odometer from the prefix's state (its source note).  A
CUDA kernel does not run here, so:

* ``_walk`` is that walk in plain Python, thread by thread, for any L and
  mixed radices.  It visits every combination once; each combination's
  ``(w, tot, tsum, cnt)`` equals, bitwise, the position-by-position model
  ``_terms`` (the kernel's order of operations, combination by index);
  its totals, summed in the kernel's order, are within 1e-9 of the
  reference's Pallas ``sojourn_enum`` in interpret mode; and the
  vectorised plain version ``sojourn_enum_torch`` is within 1e-12 of the
  model's totals;
* the plain version's NaN for an order whose strides or ``k_total`` are
  not its radix's, as the kernel answers;
* the wrapper's rule for L (``kernel.suffix_length``) at N = 26, at the
  OPTIMAL search's N = 8, P = 512 batches and where the prefix is empty;
* ``chip_smoke.static_flops``, the enumeration's bound, against a
  brute-force count of the distinct service-order prefixes.
"""

import importlib.util
import math
from itertools import product
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels import it first)
from repro.kernels.sojourn_eval import kernel as ref_kernel
from repro_torch.core import policies
from repro_torch.core.jobs import JobSpec, generate_workload
from repro_torch.kernels.sojourn_eval import kernel as K
from repro_torch.kernels.sojourn_eval import ops

RTOL = 1e-9
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jobs(stages, seed):
    """Jobs with ``stages[i]`` stages each, sizes and stop probabilities
    drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for i, k in enumerate(stages):
        probs = rng.dirichlet(np.ones(k)) if k > 1 else np.ones(1)
        out.append(JobSpec(sizes=np.cumsum(rng.uniform(0.5, 3.0, k)).tolist(),
                           probs=probs.tolist(), job_id=i))
    return out


def _inputs(stages, n_orders, seed):
    jobs = _jobs(stages, seed)
    rng = np.random.default_rng(seed + 1)
    orders = np.stack([rng.permutation(len(stages)) for _ in range(n_orders)])
    args = ops.static_kernel_args(*policies.padded_arrays(jobs), orders, torch.device("cpu"))
    return jobs, orders, args


# ---------------------------------------------------------------------------
# The kernel's walk in plain Python
# ---------------------------------------------------------------------------


def _terms(sizes_p, probs_p, s, radix):
    """Each combination's ``(w, tot, tsum, cnt)`` (T, P) from its stop stages
    ``s`` (T, P, N) in service order, in the kernel's order of operations:
    the weight product and the completion times and their sums added
    position by position."""
    d = K._permuted_gather(sizes_p, s)
    p = K._permuted_gather(probs_p, s)
    succ = s == radix - 1
    w = torch.ones(s.shape[:2], dtype=torch.float64)
    t, tsum, tot = torch.zeros_like(w), torch.zeros_like(w), torch.zeros_like(w)
    cnt = torch.zeros(s.shape[:2], dtype=torch.int64)
    for pos in range(s.shape[2]):
        w = w * p[..., pos]  # Eq. (8)
        t = t + d[..., pos]  # completion time of the pos-th served job
        tsum = tsum + t
        tot = torch.where(succ[..., pos], tot + t, tot)
        cnt = cnt + succ[..., pos].to(torch.int64)
    return w, tot, tsum, cnt


def _serve(state, p, size, success):
    w, t, tsum, tot, cnt = state
    w *= p
    t += size
    tsum += t
    if success:
        tot += t
        cnt += 1
    return w, t, tsum, tot, cnt


def _walk(sizes, probs, radix, suffix):
    """One order's walk: per thread (prefix index j), the combinations it
    visits, in its order, as (stop stages by position, (w, tot, tsum, cnt)).
    The prefix's digits come from its mixed-radix strides, last prefix
    position fastest; the suffix is an odometer whose level q keeps the
    state before position q, last position fastest."""
    n = len(radix)
    np_ = n - suffix
    strides = [math.prod(radix[pos + 1:np_]) for pos in range(np_)]
    threads = []
    for j in range(math.prod(radix[:np_])):
        state = (1.0, 0.0, 0.0, 0.0, 0)
        digits = []
        for pos in range(np_):
            d = (j // strides[pos]) % radix[pos]
            state = _serve(state, probs[pos][d], sizes[pos][d], d == radix[pos] - 1)
            digits.append(d)
        stack = [state]  # stack[q]: the state before suffix position q
        tail = [0] * suffix
        visits = []
        while True:
            while len(stack) <= suffix:  # recompute from the changed level on
                q = len(stack) - 1
                pos, d = np_ + q, tail[q]
                stack.append(_serve(stack[q], probs[pos][d], sizes[pos][d], d == radix[pos] - 1))
            w, _, tsum, tot, cnt = stack[-1]
            visits.append((tuple(digits + tail), (w, tot, tsum, cnt)))
            q = suffix - 1  # the odometer: last position fastest
            while q >= 0 and tail[q] == radix[np_ + q] - 1:
                tail[q] = 0
                q -= 1
            if q < 0:
                break
            tail[q] += 1
            del stack[q + 1:]
        threads.append(visits)
    return threads


#: (stages of each job, orders, suffix lengths): uniform M = 2, 3, 4 and
#: mixed radices with single-stage jobs; L from 0 (a thread a combination)
#: to N (an empty prefix).
CASES = [
    ([2] * 6, 2, (0, 2, 6)),
    ([3] * 5, 3, (1, 3)),
    ([4] * 4, 1, (2, 4)),
    ([3, 2, 4, 1, 2, 1], 3, (0, 1, 3, 5, 6)),
]


@pytest.mark.parametrize("stages,n_orders,suffixes", CASES,
                         ids=["m2", "m3", "m4", "mixed"])
def test_walk_matches_plain_per_combination_and_reference(stages, n_orders, suffixes):
    _, _, (sizes_p, probs_p, strides_p, radix_p, k_total) = _inputs(stages, n_orders,
                                                                   len(stages))
    # the plain version's terms of every combination index, by its decode
    k = torch.arange(k_total)
    s = (k[:, None, None] // strides_p.to(torch.int64)[None]) % radix_p.to(torch.int64)[None]
    terms = _terms(sizes_p, probs_p, s, radix_p.to(torch.int64)[None])
    w, tot, tsum, cnt = terms
    model = ((w * torch.where(cnt > 0, tot / cnt.clamp(min=1), 0.0)).sum(dim=0),
             (w * (tsum / len(stages))).sum(dim=0))
    plain = K.sojourn_enum_torch(sizes_p, probs_p, strides_p, radix_p, k_total)
    np.testing.assert_allclose(torch.stack(plain), torch.stack(model), rtol=1e-12, atol=0)
    with jax.enable_x64(True):
        ref = ref_kernel.sojourn_enum(*(np.asarray(a) for a in (sizes_p, probs_p, strides_p,
                                                                 radix_p)), k_total,
                                      interpret=True)
    for suffix in suffixes:
        for p in range(n_orders):
            sizes, probs = sizes_p[p].tolist(), probs_p[p].tolist()
            radix, strides = radix_p[p].tolist(), strides_p[p].tolist()
            threads = _walk(sizes, probs, radix, suffix)
            seen = set()
            e_succ = e_all = 0.0
            for visits in threads:
                acc_succ = acc_all = 0.0
                for digits, (w, tot, tsum, cnt) in visits:
                    idx = sum(d * st for d, st in zip(digits, strides))
                    seen.add(idx)
                    want = [terms[0][idx, p], terms[1][idx, p], terms[2][idx, p],
                            terms[3][idx, p]]
                    assert (w, tot, tsum, cnt) == tuple(x.item() for x in want), (suffix, idx)
                    acc_succ += w * (tot / cnt if cnt else 0.0)
                    acc_all += w * (tsum / len(radix))
                e_succ += acc_succ
                e_all += acc_all
            assert seen == set(range(k_total))
            np.testing.assert_allclose([e_succ, e_all], [ref[0][p], ref[1][p]], rtol=RTOL, atol=0)
            np.testing.assert_allclose([e_succ, e_all], [plain[0][p], plain[1][p]], rtol=RTOL,
                                       atol=0)


@pytest.mark.parametrize("fault", ["stride", "k_total"])
def test_plain_gives_nan_where_strides_or_count_are_not_the_radix(fault):
    """The kernel enumerates each order's own radix and checks the strides
    and the count it is given; the plain version answers as it does: NaN
    for that order, and the other orders unchanged."""
    _, _, (sizes_p, probs_p, strides_p, radix_p, k_total) = _inputs([2, 3, 2, 2], 3, 7)
    good = K.sojourn_enum(sizes_p, probs_p, strides_p, radix_p, k_total)
    if fault == "stride":
        strides_p = strides_p.clone()
        strides_p[1, 0] += 1
        bad_orders = [1]
    else:
        k_total -= 1
        bad_orders = [0, 1, 2]
    got = K.sojourn_enum(sizes_p, probs_p, strides_p, radix_p, k_total)
    for p in range(3):
        for g, want in zip(got, good):
            if p in bad_orders:
                assert torch.isnan(g[p])
            else:
                assert g[p] == want[p]


# ---------------------------------------------------------------------------
# The wrapper's rule for L
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,n_orders,k_total,want", [
    (26, 1, 1 << 26, 8),  # phase 7's N = 26: capped at MAX_SUFFIX, 2^18 threads
    (8, 512, 3**8, 3),  # the OPTIMAL search's batches: 512 x 3^5 threads
    (8, 4096, 3**8, 5),  # a batch of the reference's largest size
    (20, 3, 1 << 20, 5),  # phase 1: 3 x 2^15 threads of 32 combinations
    (4, 1 << 16, 1 << 4, 4),  # N <= L: an empty prefix, one thread an order
    (12, 1, 1 << 12, 0),  # too few combinations to fill the card: one a thread
    (1, 1, 5, 0),
])
def test_suffix_length_rule(n, n_orders, k_total, want):
    length = K.suffix_length(n, n_orders, k_total)
    assert length == want
    assert 0 <= length <= min(n, K.MAX_SUFFIX)
    threads = n_orders * K.enum_prefixes(n, length, k_total)
    if length:  # the launch fills the card, and one more position would not
        assert threads >= K.ENUM_THREADS
        if length < min(n, K.MAX_SUFFIX):
            assert n_orders * K.enum_prefixes(n, length + 1, k_total) < K.ENUM_THREADS
    else:
        assert threads == n_orders * k_total


def test_enum_prefixes_is_exact_for_uniform_radix():
    for m, n in ((2, 26), (3, 8), (4, 10), (5, 7)):
        for length in range(n + 1):
            assert K.enum_prefixes(n, length, m**n) == m ** (n - length)


# ---------------------------------------------------------------------------
# The enumeration's bound
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stages", [[2] * 5, [3] * 4, [3, 1, 2, 4, 2], [1, 1, 2]])
def test_static_flops_counts_distinct_prefixes(stages):
    cs = _chip_smoke()
    jobs = _jobs(stages, 3)
    rng = np.random.default_rng(len(stages))
    orders = np.stack([rng.permutation(len(stages)) for _ in range(3)])
    k_total = math.prod(stages)
    want = 0.0
    for order in orders:
        combos = list(product(*(range(stages[j]) for j in order)))  # in service order
        updates = sum(len({c[:q + 1] for c in combos}) for q in range(len(stages)))
        successes = sum(len({c[:q + 1] for c in combos if c[q] == stages[j] - 1})
                        for q, j in enumerate(order))
        want += 3.0 * updates + successes + 6.0 * k_total
    assert cs.static_flops(jobs, orders, k_total, mc=False) == want
    full = cs.static_flops_full_decode(jobs, len(orders), k_total)
    assert full > cs.static_flops(jobs, orders, k_total, mc=False) or k_total == 2


def test_static_flops_at_phase_7():
    """N = 26, M = 2: 3 (2^27 - 2) updates, 2^26 - 1 success adds and
    6 x 2^26 for the tails, about 13 x 2^26, against the full decode's
    (3 x 26 + 6) x 2^26 plus the success adds."""
    cs = _chip_smoke()
    jobs = generate_workload(np.random.default_rng(31), 26, 2)
    order = policies.rank_order(jobs)[None]
    got = cs.static_flops(jobs, order, 1 << 26, mc=False)
    assert got == 3.0 * (2**27 - 2) + (2**26 - 1) + 6.0 * 2**26
    assert cs.static_flops_full_decode(jobs, 1, 1 << 26) == (3 * 26 + 6) * 2**26 + 26 * 2**25
