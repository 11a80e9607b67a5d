"""The dry-run tooling against the JAX package's: shapes and cells, the
roofline arithmetic, the report, and a miniature dry run.

* ``SHAPES``, ``LONG_OK``, ``runnable_cells``, ``input_specs`` (``meta``
  tensors of the reference's shapes and dtypes) and ``make_batch_specs``;
* ``roofline_terms`` and ``model_flops`` equal to the reference's given
  the same ``Hardware``; the report's markdown;
* a 4 x 2 dry run of qwen3-1.7b SMOKE's meshed train step on the ``meta``
  device under a ``fake`` group of 8 ranks (its own process: the fake
  group cannot share one), the counterpart of the reference's
  ``test_mini_dryrun_on_host_mesh``: FLOPs and collective bytes above 0,
  and ``state_bytes_per_chip`` equal to the reference's
  ``dryrun._sharded_bytes`` of the same plan on its 8-device host mesh
  (a second process, run meanwhile);
* the dry run's cells: every one of ``runnable_cells()`` (33) on each
  production mesh;
* the same miniature dry run of the Llama-3.2-Vision and Seamless SMOKE
  decode with their cross memory, through the dry run's own cell
  program: FLOPs above 0, and the bytes of the weights and the cache a
  rank equal to the reference's ``_sharded_bytes`` of the same serving
  plan.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs import shapes as ref_shapes
from repro.data import pipeline as ref_pipeline
from repro.launch import roofline as ref_roofline
from repro_torch.configs import registry, shapes
from repro_torch.data import pipeline
from repro_torch.launch import roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(jnp.bfloat16): torch.bfloat16,
           np.dtype(np.float32): torch.float32}


def _same_specs(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert t.dtype == _DTYPES[np.dtype(want[k].dtype)], k


def test_shapes_and_cells_match_reference():
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in shapes.SHAPES.items()} == {
        k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in ref_shapes.SHAPES.items()}
    assert shapes.LONG_OK == ref_shapes.LONG_OK
    assert shapes.runnable_cells() == ref_shapes.runnable_cells()


@pytest.mark.parametrize("arch", registry.list_archs())
def test_input_specs_match_reference(arch):
    for shape in shapes.SHAPES:
        _same_specs(shapes.input_specs(arch, shape), ref_shapes.input_specs(arch, shape))
        got, want = shapes.arch_shape_config(arch, shape), ref_shapes.arch_shape_config(arch, shape)
        assert got.frontend_frames == want.frontend_frames


def test_make_batch_specs_match_reference():
    for cfg in ((32000, 128, 8), (151936, 4096, 256)):
        _same_specs(pipeline.make_batch_specs(pipeline.DataConfig(*cfg)),
                    ref_pipeline.make_batch_specs(ref_pipeline.DataConfig(*cfg)))


CASES = [
    (989e12, 3.35e12 / 2, {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
                           "all-to-all": 0}),
    (1e12, 1e9, {"all-reduce": 50e9}),
    (2.4e15, 7e12, {"all-gather": 3e10, "all-reduce": 4e10, "reduce-scatter": 1e7,
                    "all-to-all": 2e9}),
    (0.0, 0.0, {}),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_roofline_terms_match_reference(case):
    flops, nbytes, coll = CASES[case]
    hw = roofline.HW
    ref_hw = ref_roofline.Hardware(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                                   link_bw=hw.link_bw)
    assert roofline.roofline_terms(flops, nbytes, coll) == ref_roofline.roofline_terms(
        flops, nbytes, coll, hw=ref_hw)


def test_roofline_dominance_and_wire_bytes():
    r = roofline.roofline_terms(989e12, 3.35e12 / 2, {})
    assert r["dominant"] == "compute" and r["compute"] == pytest.approx(1.0)
    assert r["memory"] == pytest.approx(0.5) and r["roofline_fraction"] == pytest.approx(1.0)
    r2 = roofline.roofline_terms(1e12, 1e9, {"all-reduce": 50e9})
    assert r2["collective"] == pytest.approx(2 * 50e9 / roofline.HW.link_bw)
    assert r2["dominant"] == "collective"


@pytest.mark.parametrize("arch", registry.list_archs())
def test_model_flops_match_reference(arch):
    cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
    for name, spec in shapes.SHAPES.items():
        for mode in ("train", "prefill", "decode"):
            assert roofline.model_flops(cfg, spec, mode) == ref_roofline.model_flops(
                ref_cfg, ref_shapes.SHAPES[name], mode)


def test_roofline_report_markdown():
    rows = [{
        "arch": "a", "shape": "s", "mesh": "pod16x16",
        "roofline": {"compute": 1e-3, "memory": 2e-3, "collective": 5e-4,
                     "dominant": "memory", "roofline_fraction": 0.5,
                     "step_time_lower_bound": 2e-3,
                     "collective_bytes": {}, "collective_wire_bytes": 0},
        "useful_flops_ratio": 0.8, "state_bytes_per_chip": 2**30,
    }]
    md = roofline.RooflineReport(rows).to_markdown()
    assert "| a | s | pod16x16 |" in md and "memory" in md and "| 1.00 |" in md


PORT = textwrap.dedent("""
    import json
    import torch
    from repro_torch.configs.registry import get_smoke
    from repro_torch.data.pipeline import DataConfig, make_batch_specs
    from repro_torch.launch import dryrun, roofline as RL
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import default_plan, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.init import tree_map
    from repro_torch.optim import adamw as opt

    dryrun.init_fake_world(8)
    mesh = make_host_mesh(4, 2, device_type="cpu")
    cfg = get_smoke("qwen3-1.7b")
    plan = default_plan(cfg, mesh)
    params = tree_map(lambda t, l: plan.ctx.distribute(t, l), T.abstract_params(cfg),
                      T.param_logical(cfg))
    state = opt.adamw_init(params, plan.opt_cfg)
    batch = plan.place_batch(make_batch_specs(DataConfig(cfg.vocab_size, 64, 8)))
    flops, coll = RL.FlopCount(), RL.CollectiveBytes()
    with flops, coll:
        make_train_step(plan)(params, state, batch)
    print(json.dumps({"flops": flops.flops, "coll": coll.bytes,
                      "state": dryrun.state_bytes(params, state.mu, state.nu)}))
""")

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    from repro.configs.registry import get_smoke
    from repro.launch import dryrun
    from repro.launch.mesh import make_host_mesh
    from repro.launch.train import default_plan
    from repro.models import transformer as T
    from repro.optim import adamw as opt

    mesh = make_host_mesh(4, 2)
    cfg = get_smoke("qwen3-1.7b")
    plan = default_plan(cfg, mesh)
    params = T.abstract_params(cfg)
    state = jax.eval_shape(lambda p: opt.adamw_init(p, plan.opt_cfg), params)
    ps = plan.param_shardings()
    n = mesh.devices.size
    print(json.dumps({"state": sum(dryrun._sharded_bytes(t, ps, n)
                                   for t in (params, state.mu, state.nu))}))
""")


def test_mini_dryrun_on_a_fake_mesh_matches_reference_state_bytes(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    procs = {name: subprocess.Popen([sys.executable, "-c", code], env=env, cwd=tmp_path,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, code in (("port", PORT), ("reference", REFERENCE))}
    outs = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, f"{name}: {out[-2000:]}{err[-6000:]}"
            outs[name] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            proc.kill()
    port = outs["port"]
    assert port["flops"] > 0
    assert sum(port["coll"].values()) > 0, "a sharded train step moves bytes between ranks"
    assert port["state"] == outs["reference"]["state"]



def test_dry_run_runs_every_runnable_cell_on_each_mesh(tmp_path, monkeypatch):
    """``--mesh both`` analyses each of the 33 runnable cells on the
    (16, 16) and the (2, 16, 16) mesh (the analysis itself stubbed)."""
    from repro_torch.launch import dryrun

    seen, layouts = [], []

    def analyze(arch, shape, multi, overrides, tp_weights=False):
        seen.append((arch, shape, multi))
        layouts.append(tp_weights)
        return {"t_run_s": 0.0, "flops_per_chip": 1.0, "state_bytes_per_chip": 0,
                "roofline": {"dominant": "compute", "roofline_fraction": 1.0}}

    monkeypatch.delenv("REPRO_SERVE_TP_WEIGHTS", raising=False)
    monkeypatch.setattr(dryrun, "init_fake_world", lambda world: None)
    monkeypatch.setattr(dryrun, "analyze_cell", analyze)
    monkeypatch.setattr(dryrun.dist, "destroy_process_group", lambda: None)
    assert dryrun.main(["--mesh", "both", "--out", str(tmp_path)]) == 0
    cells = shapes.runnable_cells()
    assert len(cells) == 33
    assert seen == [(a, s, multi) for multi in (False, True) for a, s in cells]
    assert len(os.listdir(tmp_path)) == 66
    assert not any(layouts), "without the switch no cell takes the serving-weight layout"


MEMORY_ARCHS = ("llama-3.2-vision-11b", "seamless-m4t-large-v2")
MEMORY_B, MEMORY_S = 8, 64

PORT_MEMORY = textwrap.dedent("""
    import json
    import torch
    from repro_torch.configs.registry import get_smoke
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun, roofline as RL
    from repro_torch.launch.mesh import make_host_mesh

    dryrun.init_fake_world(8)
    mesh = make_host_mesh(4, 2, device_type="cpu")
    out = {}
    for arch in %(ARCHS)r:
        cfg = get_smoke(arch)
        spec = ShapeSpec("decode", %(S)d, %(B)d, "decode")
        specs = {"token": torch.empty((%(B)d, 1), dtype=torch.int32, device="meta"),
                 "pos": torch.empty((), dtype=torch.int32, device="meta")}
        step, args, state = dryrun._program(cfg, spec, mesh, False, specs)
        memory = args[-1]
        flops = RL.FlopCount()
        with flops:
            step(*args)
        out[arch] = {"flops": flops.flops, "state": dryrun.state_bytes(*state),
                     "memory": [list(m.shape) for m in memory],
                     "memory_local": [list(m.to_local().shape) for m in memory]}
    print(json.dumps(out))
""") % {"ARCHS": MEMORY_ARCHS, "S": MEMORY_S, "B": MEMORY_B}

REFERENCE_MEMORY = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    from repro.configs.registry import get_smoke
    from repro.configs.shapes import ShapeSpec
    from repro.launch import dryrun
    from repro.launch.mesh import make_host_mesh
    from repro.launch.serve import default_serve_plan
    from repro.models import transformer as T

    mesh = make_host_mesh(4, 2)
    out = {}
    for arch in %(ARCHS)r:
        cfg = get_smoke(arch)
        plan = default_serve_plan(cfg, mesh, ShapeSpec("decode", %(S)d, %(B)d, "decode"))
        params = T.abstract_params(cfg)
        cache = dryrun._abstract(T.abstract_cache(cfg, %(B)d, %(S)d))
        out[arch] = {"state": sum(dryrun._sharded_bytes(t, s, 8) for t, s in (
            (params, plan.param_shardings()), (cache, plan.cache_shardings())))}
    print(json.dumps(out))
""") % {"ARCHS": MEMORY_ARCHS, "S": MEMORY_S, "B": MEMORY_B}


def test_mini_dryrun_of_decode_with_memory_matches_reference_state_bytes(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    procs = {name: subprocess.Popen([sys.executable, "-c", code], env=env, cwd=tmp_path,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, code in (("port", PORT_MEMORY), ("reference", REFERENCE_MEMORY))}
    outs = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=240)
            assert proc.returncode == 0, f"{name}: {out[-2000:]}{err[-6000:]}"
            outs[name] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            proc.kill()
    for arch in MEMORY_ARCHS:
        port, cfg = outs["port"][arch], registry.get_smoke(arch)
        n, s_mem = ((cfg.n_layers, cfg.frontend_frames) if cfg.family == "encdec" else
                    (cfg.n_layers // cfg.cross_attn_period, cfg.num_image_tokens))
        want = [n, MEMORY_B, s_mem, cfg.n_kv_heads, cfg.hd]
        assert port["memory"] == [want, want]
        # the decode rules: batch over "model" (2), the memory's sequence over "data" (4)
        local = [n, MEMORY_B // 2, -(-s_mem // 4), cfg.n_kv_heads, cfg.hd]
        assert port["memory_local"] == [local, local]
        assert port["flops"] > 0
        assert port["state"] == outs["reference"][arch]["state"]
