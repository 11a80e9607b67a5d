"""The serving-weight layout (``default_serve_plan(tp_weights=True)``) and
the divisibility check P8, against the JAX package's.

* Placements: for each of the ten configs, on ``prefill_32k`` and
  ``decode_32k`` and on the (16, 16) and (2, 16, 16) production meshes,
  every leaf of ``param_logical`` and ``cache_logical`` gets the DTensor
  placements of the reference's ``plan.param_shardings()`` /
  ``plan.cache_shardings()`` of the same plan (the reference's on an
  ``AbstractMesh``, the port's on a stand-in mesh: no process group).
* P8: the reference's ``jit`` refuses an input whose sharded dimension
  does not divide by its mesh axes.  A reference subprocess on 8 host
  devices (4 x 2) lowers each (batch, layout) case of ``CASES`` for three
  SMOKE configs (and compiles the serving programs it accepts); the port
  refuses, with ``ValueError`` and the same sizes, exactly the cases the
  reference refuses, in ``default_serve_plan``, before any compute.  So do
  ``ServePlan.place_batch`` and ``TrainPlan.place_batch``.
* The dry run under the switch: a 4 x 2 ``fake``-group dry run of SMOKE
  decode cells (every family) in the serving-weight layout has the state
  bytes a rank of the reference's ``_sharded_bytes`` under the same plan;
  ``REPRO_SERVE_TP_WEIGHTS=1`` reaches every cell of ``dryrun.main``, and
  the long_500k cells fail under it (the reference's R8), each a
  ``[FAIL]`` line naming P8's message.

The numerics of the layout (prefill and 4 decode steps on 4 x 2 gloo
ranks against the reference's single-device logits) are in
``tests/test_torch_mesh.py``.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import registry as ref_registry
from repro.configs import shapes as ref_shapes
from repro.launch import serve as ref_serve
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import registry
from repro_torch.configs.shapes import LONG_OK, SHAPES, ShapeSpec, runnable_cells
from repro_torch.launch import serve, train
from repro_torch.models import transformer as T
from repro_torch.models.init import tree_leaves
from repro_torch.parallel import sharding

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pod": (16, 16), "multipod": (2, 16, 16)}


@dataclasses.dataclass
class _Mesh:
    """A mesh's names and sizes (what the plans read), with no devices."""

    shape: tuple
    device_type: str = "cpu"

    @property
    def mesh_dim_names(self):
        return ("pod", "data", "model")[-len(self.shape):]


class _RefMesh:
    """What the reference's ``default_serve_plan`` reads of a mesh."""

    def __init__(self, shape):
        self.axis_names = ("pod", "data", "model")[-len(shape):]
        self.devices = np.empty(shape)


def _ref_placements(sharding_, names) -> tuple:
    """DTensor placements of a reference ``NamedSharding``'s spec."""
    dims = {a: d for d, axes in enumerate(sharding_.spec)
            for a in ((axes,) if isinstance(axes, str) else axes or ())}
    return tuple(Shard(dims[a]) if a in dims else Replicate() for a in names)


def _ref_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: hasattr(x, "spec"))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", registry.list_archs())
def test_tp_plan_places_every_leaf_as_the_reference(arch, shape, mesh):
    sizes = MESHES[mesh]
    fake = _Mesh(sizes)
    names = fake.mesh_dim_names
    cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
    plan = serve.default_serve_plan(cfg, fake, SHAPES[shape], tp_weights=True)
    ref_plan = ref_serve.default_serve_plan(ref_cfg, _RefMesh(sizes), ref_shapes.SHAPES[shape],
                                            tp_weights=True)
    ref_plan = dataclasses.replace(ref_plan, mesh=AbstractMesh(sizes, names))
    for ctx, logical, want in (
            (plan.ctx, T.param_logical(cfg), ref_plan.param_shardings()),
            (plan.cache_ctx, T.cache_logical(cfg), ref_plan.cache_shardings())):
        got = [ctx.placements(log) for log in tree_leaves(logical)]
        want = [_ref_placements(s, names) for s in _ref_leaves(want)]
        assert len(got) == len(want) > 0
        assert got == want
    # the decode's cross memory, placed by MEMORY_LOGICAL under the plan's rules
    memory = ref_sharding.logical_sharding(T.MEMORY_LOGICAL, ref_plan.mesh, ref_plan.rules)
    assert plan.ctx.placements(T.MEMORY_LOGICAL) == _ref_placements(memory, names)
    # the layout itself: no weight is sharded over the data axes, so
    # ``ctx.weight`` (the weight with its "embed" dim replicated) gathers
    # nothing; the cache's sequence lies on "model"
    for log in tree_leaves(T.param_logical(cfg)):
        placed = plan.ctx.placements(log)
        assert all(pl == Replicate() for a, pl in zip(names, placed) if a != "model"), log
        assert plan.ctx.placements(tuple(None if a == "embed" else a for a in log)) == placed
    cache = plan.cache_ctx.placements(("batch", "kv_seq", "kv_heads", "head_dim"))
    assert cache[names.index("model")] == Shard(1)


def test_tp_plan_rules_and_the_default_layout():
    """``tp_weights`` applies ``serving_weight_rules`` to the shape's rules
    and the cache follows them; without it the plan is as before."""
    cfg, fake = registry.get_config("qwen3-8b"), _Mesh(MESHES["pod"])
    for shape in ("prefill_32k", "decode_32k"):
        spec = SHAPES[shape]
        base = sharding.rules_for(cfg, decode_batch=spec.kind == "decode")
        tp = serve.default_serve_plan(cfg, fake, spec, tp_weights=True)
        assert tp.rules == tp.cache_rules == sharding.serving_weight_rules(base)
        default = serve.default_serve_plan(cfg, fake, spec)
        assert default.rules == base
        assert default.cache_rules == sharding.rules_for(cfg, decode_batch=True)


# -- P8 ----------------------------------------------------------------------

P8_ARCHS = ("qwen3-1.7b", "mamba2-1.3b", "jamba-v0.1-52b")
P8_S = 64
#: name -> (batch, kind, long_context, tp_weights) on a 4 x 2 mesh
CASES = {
    "long_tp_b1": (1, "decode", True, True),
    "long_b1": (1, "decode", True, False),
    "prefill_b3": (3, "prefill", False, False),
    "prefill_b8": (8, "prefill", False, False),
    "decode_b6": (6, "decode", False, False),
    "decode_tp_b6": (6, "decode", False, True),
    "decode_tp_b8": (8, "decode", False, True),
    "train_b3": (3, "train", False, False),
    "train_b8": (8, "train", False, False),
}
REFUSED = {"long_tp_b1", "prefill_b3", "decode_tp_b6", "train_b3"}

REFERENCE_P8 = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_smoke
    from repro.configs.shapes import ShapeSpec
    from repro.launch import dryrun
    from repro.launch.mesh import make_host_mesh
    from repro.launch.serve import default_serve_plan, make_decode_fn, make_prefill_fn
    from repro.launch.train import default_plan, make_train_step
    from repro.models import transformer as T
    from repro.optim import adamw as opt

    S = %(S)d
    mesh = make_host_mesh(4, 2)
    i32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.int32)
    out = {}
    for arch in %(ARCHS)r:
        cfg = get_smoke(arch)
        params = T.abstract_params(cfg)
        for case, (b, kind, long_context, tp) in %(CASES)r.items():
            try:
                if kind == "train":
                    plan = default_plan(cfg, mesh)
                    state = jax.eval_shape(lambda p: opt.adamw_init(p, plan.opt_cfg), params)
                    make_train_step(plan).lower(params, state,
                                                {"tokens": i32(b, S), "labels": i32(b, S)})
                    out[arch + " " + case] = "lowered"
                    continue
                plan = default_serve_plan(cfg, mesh, ShapeSpec(case, S, b, kind),
                                          long_context=long_context, tp_weights=tp)
                if kind == "prefill":
                    lowered = make_prefill_fn(plan).lower(params, {"tokens": i32(b, S)})
                else:
                    cache = dryrun._abstract(T.abstract_cache(cfg, b, S))
                    lowered = make_decode_fn(plan).lower(params, i32(b, 1), cache, i32())
                lowered.compile()
                out[arch + " " + case] = "compiled"
            except ValueError as e:
                out[arch + " " + case] = "ValueError: " + str(e)
    print(json.dumps(out))
""") % {"S": P8_S, "ARCHS": P8_ARCHS, "CASES": CASES}

SIZES = re.compile(r"divisible by (\d+), but it is equal to (\d+)")


@pytest.fixture(scope="module")
def reference_p8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("p8")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", REFERENCE_P8], env=env, cwd=tmp,
                          capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-6000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _port_outcome(arch: str, case: str) -> str:
    """The port's plan (and, for a train case, its batch placement, with
    DTensor's placement itself stubbed out) on a 4 x 2 stand-in mesh: "ok"
    or the ValueError's message."""
    b, kind, long_context, tp = CASES[case]
    cfg, fake = registry.get_smoke(arch), _Mesh((4, 2))
    try:
        if kind == "train":
            batch = {k: torch.zeros((b, P8_S), dtype=torch.long) for k in ("tokens", "labels")}
            train.default_plan(cfg, fake).place_batch(batch)
        else:
            serve.default_serve_plan(cfg, fake, ShapeSpec(case, P8_S, b, kind),
                                     long_context=long_context, tp_weights=tp)
    except ValueError as e:
        return f"ValueError: {e}"
    return "ok"


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", P8_ARCHS)
def test_port_refuses_what_the_reference_jit_refuses(reference_p8, arch, case, monkeypatch):
    import torch.distributed.tensor as dtensor

    monkeypatch.setattr(dtensor, "distribute_tensor", lambda t, *args, **kw: t)
    ref, got = reference_p8[f"{arch} {case}"], _port_outcome(arch, case)
    refused = case in REFUSED
    assert ref.startswith("ValueError") == refused, ref
    assert got.startswith("ValueError") == refused, got
    if refused:
        # the same dimension size and the same product of mesh axes
        assert SIZES.search(ref).groups() == SIZES.search(got).groups(), (ref, got)
    else:
        assert ref == ("lowered" if CASES[case][1] == "train" else "compiled")


def test_place_batch_refuses_a_batch_that_does_not_divide():
    """A plan made for 8 requests refuses a batch of 3 rows in
    ``place_batch`` (before placing anything: the stand-in mesh has no
    devices), and names the entry; a divisible batch passes the check."""
    cfg, fake = registry.get_smoke("qwen3-1.7b"), _Mesh((4, 2))
    plan = serve.default_serve_plan(cfg, fake, ShapeSpec("p", 16, 8, "prefill"))
    with pytest.raises(ValueError,
                       match=r"batch\['tokens'\].*divisible by 4, but it is equal to 3"):
        plan.place_batch({"tokens": torch.zeros((3, 16), dtype=torch.long)})
    with pytest.raises(ValueError, match="the token.*divisible by 4, but it is equal to 3"):
        plan.place(torch.zeros((3, 1), dtype=torch.long), ("batch", None), "the token")
    vision = registry.get_smoke("llama-3.2-vision-11b")
    vplan = serve.default_serve_plan(vision, fake, ShapeSpec("p", 16, 8, "prefill"))
    with pytest.raises(ValueError, match=r"batch\['image_embeds'\]"):
        vplan.place_batch({"image_embeds": torch.zeros((6, 16, 32))})
    tplan = train.default_plan(cfg, fake)
    with pytest.raises(ValueError, match=r"batch\['labels'\].*equal to 2"):
        tplan.place_batch({"labels": torch.zeros((2, 16), dtype=torch.long)})
    for t in (torch.zeros((8, 16)), torch.zeros((1, 16))):
        sharding.check_divisible("x", t.shape, ("batch", "seq"), _Mesh((1, 2)),
                                 sharding.DEFAULT_RULES)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_production_cells_divide_except_long_context_under_tp(mesh):
    """Every runnable serving cell's plan builds on a production mesh in
    both layouts, except the long_500k cells under ``tp_weights`` (R8)."""
    fake = _Mesh(MESHES[mesh])
    for arch, shape in runnable_cells():
        spec = SHAPES[shape]
        if spec.kind == "train":
            continue
        cfg = registry.get_config(arch)
        long_context = shape == "long_500k"
        serve.default_serve_plan(cfg, fake, spec, long_context=long_context)
        if long_context:
            with pytest.raises(ValueError, match="equal to 1"):
                serve.default_serve_plan(cfg, fake, spec, long_context=True, tp_weights=True)
        else:
            serve.default_serve_plan(cfg, fake, spec, tp_weights=True)


# -- the dry run under the switch --------------------------------------------

DRY_ARCHS = ("qwen3-1.7b", "mixtral-8x22b", "mamba2-1.3b", "jamba-v0.1-52b",
             "llama-3.2-vision-11b", "seamless-m4t-large-v2")
DRY_B, DRY_S = 8, 64

PORT_DRY = textwrap.dedent("""
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
        step, args, state = dryrun._program(cfg, spec, mesh, False, specs, tp_weights=True)
        flops, coll = RL.FlopCount(), RL.CollectiveBytes()
        with flops, coll:
            step(*args)
        out[arch] = {"flops": flops.flops, "coll": coll.bytes,
                     "state": dryrun.state_bytes(*state)}
    print(json.dumps(out))
""") % {"ARCHS": DRY_ARCHS, "S": DRY_S, "B": DRY_B}

REFERENCE_DRY = textwrap.dedent("""
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
        plan = default_serve_plan(cfg, mesh, ShapeSpec("decode", %(S)d, %(B)d, "decode"),
                                  tp_weights=True)
        params = T.abstract_params(cfg)
        cache = dryrun._abstract(T.abstract_cache(cfg, %(B)d, %(S)d))
        out[arch] = {"state": sum(dryrun._sharded_bytes(t, s, 8) for t, s in (
            (params, plan.param_shardings()), (cache, plan.cache_shardings())))}
    print(json.dumps(out))
""") % {"ARCHS": DRY_ARCHS, "S": DRY_S, "B": DRY_B}


@pytest.fixture(scope="module")
def dry_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dry")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="")
    procs = {name: subprocess.Popen([sys.executable, "-c", code], env=env, cwd=tmp,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, code in (("port", PORT_DRY), ("reference", REFERENCE_DRY))}
    outs = {}
    try:
        for name, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, f"{name}: {out[-2000:]}{err[-6000:]}"
            outs[name] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            proc.kill()
    return outs


@pytest.mark.parametrize("arch", DRY_ARCHS)
def test_tp_dry_run_state_bytes_match_reference(dry_runs, arch):
    port = dry_runs["port"][arch]
    assert port["flops"] > 0
    assert port["state"] == dry_runs["reference"][arch]["state"]


def _stub_dryrun(monkeypatch, seen: list, analyze=None):
    from repro_torch.launch import dryrun

    def stub(arch, shape, multi, overrides, tp_weights=False):
        seen.append((arch, shape, multi, tp_weights))
        return {"t_run_s": 0.0, "flops_per_chip": 1.0, "state_bytes_per_chip": 0,
                "tp_weights": tp_weights,
                "roofline": {"dominant": "compute", "roofline_fraction": 1.0}}

    monkeypatch.setattr(dryrun, "init_fake_world", lambda world: None)
    monkeypatch.setattr(dryrun, "analyze_cell", analyze or stub)
    monkeypatch.setattr(dryrun.dist, "destroy_process_group", lambda: None)
    return dryrun


@pytest.mark.parametrize("value,want", [("1", True), ("0", False), (None, False)])
def test_switch_reaches_every_cell(tmp_path, monkeypatch, value, want):
    """``REPRO_SERVE_TP_WEIGHTS`` is read when ``main`` runs (set here
    after the import), and only "1" turns the layout on, for every cell."""
    if value is None:
        monkeypatch.delenv("REPRO_SERVE_TP_WEIGHTS", raising=False)
    else:
        monkeypatch.setenv("REPRO_SERVE_TP_WEIGHTS", value)
    seen = []
    dryrun = _stub_dryrun(monkeypatch, seen)
    assert dryrun.main(["--mesh", "both", "--out", str(tmp_path), "--tag", "tp"]) == 0
    assert len(seen) == 2 * len(runnable_cells())
    assert {tp for *_, tp in seen} == {want}
    rows = [json.loads((tmp_path / f).read_text()) for f in os.listdir(tmp_path)]
    assert len(rows) == len(seen) and all(r["tp_weights"] is want for r in rows)
    assert all(f.endswith("__tp.json") for f in os.listdir(tmp_path))


def test_long_context_cells_fail_under_the_switch(tmp_path, monkeypatch, capsys):
    """Under the switch each long_500k cell is a ``[FAIL]`` line with P8's
    message (the plan of each cell built on a stand-in production mesh),
    and ``main`` returns 1; every other cell's plan builds."""
    monkeypatch.setenv("REPRO_SERVE_TP_WEIGHTS", "1")

    def plan_only(arch, shape, multi, overrides, tp_weights=False):
        spec = SHAPES[shape]
        fake = _Mesh(MESHES["multipod" if multi else "pod"])
        if spec.kind != "train":
            serve.default_serve_plan(registry.get_config(arch), fake, spec,
                                     long_context=shape == "long_500k", tp_weights=tp_weights)
        return {"t_run_s": 0.0, "flops_per_chip": 1.0, "state_bytes_per_chip": 0,
                "roofline": {"dominant": "compute", "roofline_fraction": 1.0}}

    dryrun = _stub_dryrun(monkeypatch, [], plan_only)
    assert dryrun.main(["--mesh", "both", "--out", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    failed = re.findall(r"^\[FAIL\] (\S+): (.*)$", out, re.M)
    want = {f"{arch}__long_500k__{mesh}" for arch in LONG_OK for mesh in ("single", "multi")}
    assert {tag for tag, _ in failed} == want
    for _, msg in failed:
        assert "divisible by" in msg and "but it is equal to 1" in msg, msg
    assert len(os.listdir(tmp_path)) == 2 * (len(runnable_cells()) - len(LONG_OK))
