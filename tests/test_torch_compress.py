"""Int8 error-feedback compression against the JAX package's, bit for bit.

``quantize``, ``dequantize`` and ``ef_compress`` on the same float32 and
bf16 inputs, including ties at .5 (``torch.round`` and ``jnp.round``
both round half to even), zeros (the 1e-12 scale floor) and a residual
carried across steps.  ``compressed_psum`` runs on 4 gloo ranks (one
spawn of a script under ``tmp_path``, ranks joined through a ``file://``
store there, a 120 s limit), each with its own gradient shard and
residual, against the reference's formula (``compress.py:60-68``)
evaluated here with the reference's own ``ef_compress`` and
``dequantize`` on the same shards.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import compress as ref_compress
from repro_torch.optim import compress

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 4


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "normal": rng.standard_normal((64, 33)).astype(np.float32),
        # amax 127, so the scale is 1 and every x.5 is a tie
        "ties": np.concatenate([np.arange(-127, 128), np.arange(-126.5, 127, 1.0)])
        .astype(np.float32),
        "zeros": np.zeros((7, 5), np.float32),
        "tiny": (rng.standard_normal(100) * 1e-15).astype(np.float32),
        "large": (rng.standard_normal((3, 4, 5)) * 1e4).astype(np.float32),
    }


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("name", list(_inputs()))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_bitwise(name, dtype):
    x = _inputs()[name]
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    q_want, s_want = ref_compress.quantize(jnp.asarray(x))
    q, s = compress.quantize(_torch(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_want))
    assert np.asarray(s_want).astype(np.float32).tobytes() == np.float32(_np(s)).tobytes()
    deq_want = np.asarray(ref_compress.dequantize(q_want, s_want))
    deq = compress.dequantize(q, s)
    assert deq.dtype == torch.float32
    np.testing.assert_array_equal(deq.numpy(), deq_want)


def test_ties_round_half_to_even():
    q, _ = compress.quantize(torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5]))
    assert q.tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ef_compress_bitwise_over_steps(dtype):
    rng = np.random.default_rng(1)
    r_want = np.zeros((50, 20), np.float32)
    r = torch.zeros((50, 20))
    for _ in range(3):
        g = rng.standard_normal((50, 20)).astype(np.float32)
        if dtype == "bfloat16":
            g = g.astype(ml_dtypes.bfloat16)
        q_want, s_want, r_want = ref_compress.ef_compress(jnp.asarray(g), jnp.asarray(r_want))
        q, s, r = compress.ef_compress(_torch(g), r)
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_want))
        assert np.float32(s_want).tobytes() == np.float32(s).tobytes()
        r_want = np.asarray(r_want)
        np.testing.assert_array_equal(r.numpy(), r_want)


PSUM = textwrap.dedent('''
    import pickle, sys
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def run(rank, world, store, data_path, out_path):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=100))
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.optim.compress import compressed_psum

        with open(data_path, "rb") as f:
            shards = pickle.load(f)[rank]
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
        grads = {k: torch.from_numpy(v) for k, v in shards["grads"].items()}
        res = {k: torch.from_numpy(v) for k, v in shards["residuals"].items()}
        mean, new_res = compressed_psum(grads, res, mesh, axes=("pod", "data"))
        out = {"mean": {k: v.numpy() for k, v in mean.items()},
               "residuals": {k: v.numpy() for k, v in new_res.items()}}
        with open(f"{out_path}.{rank}", "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()


    if __name__ == "__main__":
        store, data_path, out_path, world = sys.argv[1:]
        mp.spawn(run, args=(int(world), store, data_path, out_path), nprocs=int(world))
''')


def test_compressed_psum_on_four_ranks_matches_reference_formula(tmp_path):
    rng = np.random.default_rng(2)
    shapes = {"a": (16, 8), "b": (33,), "c": (2, 3, 4)}
    shards = [{"grads": {k: (rng.standard_normal(s) * (r + 1)).astype(np.float32)
                         for k, s in shapes.items()},
               "residuals": {k: (rng.standard_normal(s) * 1e-3).astype(np.float32)
                             for k, s in shapes.items()}} for r in range(RANKS)]
    with open(tmp_path / "data.pkl", "wb") as f:
        pickle.dump(shards, f)
    (tmp_path / "psum.py").write_text(PSUM)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(tmp_path / "psum.py"), str(tmp_path / "store"),
                           str(tmp_path / "data.pkl"), str(tmp_path / "out.pkl"),
                           str(RANKS)], env=env, capture_output=True, text=True, timeout=120,
                          cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    for k in shapes:
        # the reference's formula on the same shards
        parts = [ref_compress.ef_compress(jnp.asarray(sh["grads"][k]),
                                          jnp.asarray(sh["residuals"][k])) for sh in shards]
        scale_max = jnp.max(jnp.stack([s for _, s, _ in parts]))
        lanes = [jnp.round(ref_compress.dequantize(q, s) / scale_max).astype(jnp.int32)
                 for q, s, _ in parts]
        total = sum(lanes[1:], lanes[0])
        want = np.asarray((total.astype(jnp.float32) * scale_max / RANKS).astype(jnp.float32))
        for r in range(RANKS):
            with open(f"{tmp_path / 'out.pkl'}.{r}", "rb") as f:
                got = pickle.load(f)
            np.testing.assert_array_equal(got["mean"][k], want)
            np.testing.assert_array_equal(got["residuals"][k], np.asarray(parts[r][2]))
