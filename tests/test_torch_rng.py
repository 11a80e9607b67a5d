"""Port parity of the Threefry counter stream, bit for bit.

The streamed Monte-Carlo kernels decode outcomes from
``threefry2x32(seed; x0 = sample, x1 = job)``.  The port's NumPy and
int64-masked PyTorch bodies must give the JAX package's bits exactly,
and its host replay the reference's outcome tables exactly.
"""

import numpy as np
import pytest
import torch

from repro.kernels.sojourn_eval import ref as ref_ref
from repro.kernels.sojourn_eval import rng as ref_rng
from repro_torch.kernels.sojourn_eval import ref as port_ref
from repro_torch.kernels.sojourn_eval import rng as port_rng

SEEDS = (0, 0x5EED_CAFE, port_rng.MAX_SEED - 1)


def _counters():
    x0 = np.concatenate([
        np.arange(2048, dtype=np.uint64),
        np.array([2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], dtype=np.uint64),
    ]).astype(np.uint32)
    x1 = ((x0.astype(np.uint64) * 2654435761) % 977).astype(np.uint32)
    return x0, x1


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_matches_reference_bitwise(seed):
    key = ref_rng.split_seed(seed)
    x0, x1 = _counters()
    want0, want1 = ref_rng.threefry2x32(np, key, x0, x1)
    np_0, np_1 = port_rng.threefry2x32(port_rng.split_seed(seed), x0, x1)
    t0, t1 = port_rng.threefry2x32_torch(
        port_rng.split_seed(seed),
        torch.from_numpy(x0.astype(np.int64)), torch.from_numpy(x1.astype(np.int64)),
    )
    np.testing.assert_array_equal(np_0, want0)
    np.testing.assert_array_equal(np_1, want1)
    np.testing.assert_array_equal(t0.numpy(), want0.astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), want1.astype(np.int64))


def test_uniforms_exact_and_in_range():
    bits = torch.tensor([0, 1, 2**31, 2**32 - 1], dtype=torch.int64)
    u = port_rng.uniform_from_bits(bits)
    assert u.dtype == torch.float64
    np.testing.assert_array_equal(
        u.numpy(), ref_rng.uniform_from_bits(bits.numpy().astype(np.uint32), np.float64)
    )
    assert float(u.max()) < 1.0


@pytest.mark.parametrize("seed", SEEDS)
def test_split_seed_matches_reference(seed):
    assert port_rng.split_seed(seed) == ref_rng.split_seed(seed)


@pytest.mark.parametrize("seed", (-1, port_rng.MAX_SEED))
def test_split_seed_rejects_out_of_range(seed):
    with pytest.raises(ValueError):
        port_rng.split_seed(seed)


@pytest.mark.parametrize("seed,n,m", [(SEEDS[1], 5, 3), (SEEDS[2], 7, 2), (12345, 3, 1)])
def test_host_replay_matches_reference_bitwise(seed, n, m):
    probs = np.random.default_rng(n).dirichlet(np.ones(m), size=n)
    num_stages = np.full(n, m)
    num_stages[0] = max(1, m - 1)  # a ragged job: its padded stage has 0 mass
    probs[0, num_stages[0]:] = 0.0
    probs[0] /= probs[0].sum()
    np.testing.assert_array_equal(
        port_rng.host_uniforms(seed, 17, 300, n), ref_rng.host_uniforms(seed, 17, 300, n)
    )
    want, want_w = ref_ref.ref_mc_outcomes(probs, num_stages, seed, 1000)
    got, got_w = port_ref.ref_mc_outcomes(probs, num_stages, seed, 1000)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_w, want_w)
