"""The port's axis rules against the JAX package's.

``AxisRules.resolve`` gives, for every leaf of ``param_logical`` and
``cache_logical`` of the ten full configs, the reference's
``PartitionSpec`` as a tuple, on ("data", "model") and ("pod", "data",
"model") meshes (stand-ins with axis names: resolving needs no devices),
under the default, long-context, decode-batch and serving-weight rules at
a model axis of 16.  The port's logical trees equal the reference's.
:func:`placements` turns a resolution into DTensor placements, checked
against hand-built cases, and :func:`shard_pytree_spec` gives every leaf
of the parameter and cache trees the placements of the reference's
specs.
"""

import jax
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro.configs import registry as ref_registry
from repro.models import transformer as ref_T
from repro.parallel import sharding as ref_sharding
from repro_torch.configs import registry
from repro_torch.models import transformer as T
from repro_torch.models.init import tree_leaves
from repro_torch.parallel import sharding

MESHES = {"pod": ("data", "model"), "multipod": ("pod", "data", "model")}


class _Mesh:
    """Axis names only, as both packages' ``resolve`` reads them."""

    def __init__(self, names):
        self.axis_names = names
        self.mesh_dim_names = names
        self.empty = False


def _rule_tables(pkg, cfg):
    """(name, rules) of the default, long-context, decode-batch and
    serving-weight tables of ``pkg`` (either sharding module) for ``cfg``."""
    base = pkg.rules_for(cfg, model_axis=16)
    decode = pkg.rules_for(cfg, decode_batch=True, model_axis=16)
    return [("default", base),
            ("long_context", pkg.rules_for(cfg, long_context=True, model_axis=16)),
            ("decode_batch", decode),
            ("serving_weights", pkg.serving_weight_rules(decode))]


def _ref_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", registry.list_archs())
def test_resolve_matches_reference_for_every_leaf(arch, mesh):
    names = MESHES[mesh]
    ref_cfg, cfg = ref_registry.get_config(arch), registry.get_config(arch)
    leaves = {"params": (_ref_leaves(ref_T.param_logical(ref_cfg)),
                         tree_leaves(T.param_logical(cfg))),
              "cache": (_ref_leaves(ref_T.cache_logical(ref_cfg)),
                        tree_leaves(T.cache_logical(cfg)))}
    for (name, want_rules), (_, got_rules) in zip(_rule_tables(ref_sharding, ref_cfg),
                                                  _rule_tables(sharding, cfg)):
        for tree, (want_leaves, got_leaves) in leaves.items():
            for logical in want_leaves:
                want = tuple(want_rules.resolve(logical, _Mesh(names)))
                got = got_rules.resolve(logical, _Mesh(names))
                assert got == want, (name, tree, logical)


@pytest.mark.parametrize("arch", registry.list_archs())
def test_logical_trees_match_reference(arch):
    ref_cfg, cfg = ref_registry.get_config(arch), registry.get_config(arch)
    assert tree_leaves(T.param_logical(cfg)) == _ref_leaves(ref_T.param_logical(ref_cfg))
    assert tree_leaves(T.cache_logical(cfg)) == _ref_leaves(ref_T.cache_logical(ref_cfg))
    # the cache tree has init_cache's structure
    smoke = registry.get_smoke(arch)
    abstract = T.abstract_cache(smoke, 2, 8)
    assert [t.dim() for t in tree_leaves(abstract)] == [
        len(log) for log in tree_leaves(T.cache_logical(smoke))]
    assert all(t.device.type == "meta" for t in tree_leaves(T.abstract_params(cfg)))


PLACEMENT_CASES = [
    (("embed", "mlp"), MESHES["pod"], sharding.DEFAULT_RULES, (Shard(0), Shard(1))),
    (("embed", "mlp"), MESHES["multipod"], sharding.DEFAULT_RULES,
     (Shard(0), Shard(0), Shard(1))),
    (("batch", "seq", None), MESHES["pod"], sharding.DEFAULT_RULES, (Shard(0), Replicate())),
    (("q_heads", "mlp"), MESHES["pod"], sharding.DEFAULT_RULES, (Replicate(), Shard(0))),
    (("batch", "kv_seq"), MESHES["pod"], sharding.LONG_CONTEXT_RULES, (Shard(1), Replicate())),
    (("layers", "batch", "kv_seq", "kv_heads", "head_dim"), MESHES["multipod"],
     sharding.rules_for(None, decode_batch=True), (Shard(1), Shard(2), Shard(1))),
    ((), MESHES["pod"], sharding.DEFAULT_RULES, (Replicate(), Replicate())),
]


@pytest.mark.parametrize("logical,names,rules,want", PLACEMENT_CASES,
                         ids=[f"case{i}" for i in range(len(PLACEMENT_CASES))])
def test_placements_of_hand_built_cases(logical, names, rules, want):
    assert sharding.placements(logical, _Mesh(names), rules) == want


def test_rule_tables_match_reference():
    """The four tables themselves, name by name."""
    for mine, ref in ((sharding.DEFAULT_RULES, ref_sharding.DEFAULT_RULES),
                      (sharding.LONG_CONTEXT_RULES, ref_sharding.LONG_CONTEXT_RULES)):
        assert dict(mine.rules) == dict(ref.rules)
    mixtral = registry.get_config("mixtral-8x22b")
    rules = sharding.rules_for(mixtral, model_axis=16)
    assert rules.resolve(("experts", "embed", "expert_mlp"), _Mesh(MESHES["pod"])) == (
        None, "data", "model")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", registry.list_archs())
def test_shard_pytree_spec_places_every_leaf_as_the_reference(arch, mesh):
    """Each mesh dim of a leaf's placements is ``Shard(d)`` exactly where
    the reference's default-rule spec puts that mesh axis on dim ``d``."""
    names = MESHES[mesh]
    ref_cfg, cfg = ref_registry.get_config(arch), registry.get_config(arch)
    ref_rules, rules = ref_sharding.rules_for(ref_cfg), sharding.rules_for(cfg)
    for ref_tree, tree in ((ref_T.param_logical(ref_cfg), T.param_logical(cfg)),
                           (ref_T.cache_logical(ref_cfg), T.cache_logical(cfg))):
        got = tree_leaves(sharding.shard_pytree_spec(tree, _Mesh(names), rules))
        want = [tuple(ref_rules.resolve(logical, _Mesh(names)))
                for logical in _ref_leaves(ref_tree)]
        assert len(got) == len(want)
        for pl, spec in zip(got, want):
            dims = {a: d for d, axes in enumerate(spec)
                    for a in ((axes,) if isinstance(axes, str) else axes or ())}
            assert pl == tuple(Shard(dims[a]) if a in dims else Replicate() for a in names)
