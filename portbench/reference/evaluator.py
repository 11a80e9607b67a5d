"""Plain reference of E[sojourn time of successful jobs] for one job group.

The semantics of the paper's Eqs. (7)-(9), written afresh in PyTorch on
whatever device it is given, in the precision it is given (float64 is
the configuration's; float32 is the control's).  It shares no code with
the program and takes nothing the program computed: the group's arrays
are the benchmark's own, and the policies' orders and index tables, the
Monte-Carlo seed and the stream are worked out here again.

* A group is ``sizes`` (N, M) cumulative checkpoint sizes and ``probs``
  (N, M) stop probabilities, every job with M stages.  Job i stops at
  stage ``s_i``; ``s_i == M - 1`` is a success.  A combination with no
  success contributes 0.
* ``evaluation: exact`` enumerates all ``M**N`` combinations (job 0 the
  most significant digit), each weighted by the product of its stop
  probabilities.
* ``evaluation: monte_carlo`` draws one seed in ``[0, mc_seed_bound)``
  from the caller's generator before any policy, and samples ``mc_samples``
  outcomes from the Threefry stream (:mod:`.threefry`): job i's stage in
  sample k is the count of the job's CDF entries at or below the uniform
  of (k, i), at most ``M - 1``; each sample weighs ``1 / mc_samples``.
* A policy is a file ``policies/<name>.py`` with ``KIND`` and ``plan``.
  ``KIND = "order"``: ``plan`` gives a service order, and each job runs to
  its stop with no preemption; a job completes at the sum of the realized
  sizes served up to it.  ``KIND = "optimum"``: ``plan`` gives (P, N)
  orders, and the policy's value is the least of theirs (exact
  evaluation only).  ``KIND = "index"``: ``plan`` gives an (N, M)
  index table; one server always serves, for one stage, the unfinished
  job whose index at its next stage is least (ties to the lower job), and
  never one whose index is ``+inf``.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch

from portbench.reference import threefry

__all__ = ["POLICY_DIR", "load_policy", "evaluate"]

POLICY_DIR = Path(__file__).resolve().parent / "policies"
#: (rows x jobs) elements of one tile of combinations or samples.
TILE_ELEMS = 1 << 27


def load_policy(name: str):
    """The module of ``policies/<name>.py``, found by its file name."""
    mod_name = "portbench_policy_" + "".join(c if c.isalnum() else "_" for c in name)
    mod = sys.modules.get(mod_name)
    if mod is None:
        path = POLICY_DIR / f"{name}.py"
        if not path.is_file():
            raise ValueError(f"no reference policy {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[mod_name] = mod
    return mod


def _static_means(realized, succ, orders):
    """(rows, P): per row and order of ``orders`` (P, N), the mean
    completion time of the successful jobs (0 if none) when the jobs run in
    that order."""
    t = torch.cumsum(realized[:, orders], dim=2)
    won = succ[:, orders]
    cnt = won.sum(dim=2)
    return torch.where(cnt > 0, (t * won).sum(dim=2) / cnt.clamp(min=1), 0.0)


def _dynamic_mean(s, succ, idx, dur):
    """Per row, the mean completion time of the successful jobs (0 if none)
    under the index table ``idx`` on one server.  ``key`` holds each job's
    index at the stage it waits for (``+inf`` once it has stopped); every
    step serves the least for one stage."""
    rows_n, n = s.shape
    m = idx.shape[1]
    dev = s.device
    rows = torch.arange(rows_n, device=dev)
    key = idx[:, 0].expand(rows_n, n).clone()
    stage = torch.zeros((rows_n, n), dtype=torch.int64, device=dev)
    clock = torch.zeros(rows_n, dtype=idx.dtype, device=dev)
    tot = torch.zeros_like(clock)
    cnt = torch.zeros(rows_n, dtype=torch.int64, device=dev)
    inf = torch.tensor(float("inf"), dtype=idx.dtype, device=dev)
    for _ in range(n * m):
        kmin, j = key.min(dim=1)
        live = kmin < inf
        sj = stage[rows, j].clamp(max=m - 1)
        clock = clock + torch.where(live, dur[j, sj], 0.0)
        stop = live & (sj == s[rows, j])
        won = stop & succ[rows, j]
        tot = tot + torch.where(won, clock, 0.0)
        cnt = cnt + won.to(torch.int64)
        nxt = idx[j, (sj + 1).clamp(max=m - 1)]
        key[rows, j] = torch.where(live, torch.where(stop, inf, nxt), key[rows, j])
        stage[rows, j] = sj + live.to(torch.int64)
    return torch.where(cnt > 0, tot / cnt.clamp(min=1), 0.0)


def _exact_tiles(probs_t, n, m, device):
    """(stop stages (T, N), weights (T,)) over every combination."""
    k_total = m**n
    strides = torch.tensor([m ** (n - 1 - i) for i in range(n)], dtype=torch.int64,
                           device=device)
    jobs = torch.arange(n, device=device)[None, :]
    rows = max(1, TILE_ELEMS // n)
    for lo in range(0, k_total, rows):
        k = torch.arange(lo, min(lo + rows, k_total), dtype=torch.int64, device=device)
        s = (k[:, None] // strides[None, :]) % m
        yield s, probs_t[jobs, s].prod(dim=1)


def _mc_tiles(cdf_t, seed, n_samples, n, m, device):
    """(stop stages (T, N), None) over the samples of the stream."""
    key = threefry.split_seed(seed)
    jobs = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    rows = max(1, TILE_ELEMS // n)
    for lo in range(0, n_samples, rows):
        k = torch.arange(lo, min(lo + rows, n_samples), dtype=torch.int64, device=device)
        bits, _ = threefry.threefry2x32_torch(key, k[:, None].expand(-1, n),
                                               jobs.expand(len(k), -1))
        u = bits.to(cdf_t.dtype) * 2.0**-32
        s = (u[:, :, None] >= cdf_t[None]).sum(dim=2).clamp(max=m - 1)
        yield s, None


def evaluate(sizes, probs, config: dict, rng: np.random.Generator,
             dtype: torch.dtype = torch.float64, device="cpu") -> dict[str, float]:
    """E[sojourn time of successful jobs] of the group under each of
    ``config["policies"]``, consuming ``rng`` as the configuration states:
    the Monte-Carlo seed first, then each policy's draws in order."""
    np_dtype = {torch.float64: np.float64, torch.float32: np.float32}[dtype]
    sizes = np.asarray(sizes, dtype=np.float64).astype(np_dtype)
    probs = np.asarray(probs, dtype=np.float64).astype(np_dtype)
    n, m = sizes.shape
    if int(config.get("n_servers", 1)) != 1:
        raise ValueError("the reference simulates index policies on one server")
    mode = config["evaluation"]
    if mode == "monte_carlo":
        seed = int(rng.integers(0, int(config["mc_seed_bound"])))
        n_samples = int(config["mc_samples"])
    elif mode == "exact":
        if m**n > int(config["max_exact_combos"]):
            raise ValueError(f"{m}**{n} combinations exceed max_exact_combos")
    else:
        raise ValueError(f"unknown evaluation {mode!r}")
    plans = []
    for name in config["policies"]:
        pol = load_policy(name)
        plans.append((name, pol.KIND, pol.plan(sizes, probs, rng)))

    def dev_t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np_dtype), device=device)

    sizes_t = dev_t(sizes)
    dur_t = dev_t(np.diff(sizes, axis=1, prepend=0.0))
    jobs = torch.arange(n, device=device)[None, :]
    prepared = []
    for name, kind, plan in plans:
        if kind == "order":
            plan = np.asarray(plan)[None]
        elif kind == "optimum":
            if mode != "exact":
                raise ValueError(f"policy {name!r} is evaluated exactly only")
        elif kind != "index":
            raise ValueError(f"policy {name!r}: unknown KIND {kind!r}")
        if kind == "index":
            prepared.append((kind, dev_t(plan)))
        else:
            prepared.append((kind, torch.as_tensor(np.asarray(plan), dtype=torch.int64,
                                                   device=device)))
    if mode == "exact":
        tiles = _exact_tiles(dev_t(probs), n, m, device)
    else:
        tiles = _mc_tiles(dev_t(np.cumsum(probs, axis=1)), seed, n_samples, n, m, device)
    acc = [torch.zeros(len(plan) if kind != "index" else 1, dtype=dtype, device=device)
           for kind, plan in prepared]
    for s, w in tiles:
        succ = s == m - 1
        realized = sizes_t[jobs, s]
        for p, (kind, plan) in enumerate(prepared):
            if kind == "index":
                mean = _dynamic_mean(s, succ, plan, dur_t)[:, None]
                acc[p] += mean.sum(dim=0) if w is None else w @ mean
                continue
            step = max(1, TILE_ELEMS // (len(s) * n))
            for lo in range(0, len(plan), step):
                mean = _static_means(realized, succ, plan[lo:lo + step])
                acc[p][lo:lo + step] += mean.sum(dim=0) if w is None else w @ mean
    values = torch.stack([a.min() for a in acc])
    if mode == "monte_carlo":
        values = values / n_samples
    return {name: float(v) for (name, _, _), v in zip(plans, values.cpu())}
