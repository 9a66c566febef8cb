"""``repro_torch.distributed.sharding`` against ``repro.distributed.sharding``.

``spec_for`` equals the reference's ``PartitionSpec`` (as tuples) on every
parameter and cache leaf of every architecture, under the rules each
package's autoshard picks on both production meshes.  On a 1 x 1 gloo mesh
(a one-rank process group made and destroyed by a fixture), ``constrain``
and ``param_shardings`` place tensors as DTensors whose local shards equal
the tensors.
"""

import socket

import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JaxAbstractMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro.configs import ALL_ARCHS, SHAPES, cell_applicable, get_config
from repro.distributed.autoshard import best_rules as ref_best_rules
from repro.distributed.sharding import ShardingRules as RefRules
from repro.models import LM as RefLM
from repro.models.layers import ParamSpec as RefParamSpec
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs import get_smoke
from repro_torch.distributed import (
    ShardingRules,
    constrain,
    current_rules,
    logical_to_spec,
    param_shardings,
    use_rules,
)
from repro_torch.distributed.autoshard import best_rules
from repro_torch.distributed.sharding import PartitionSpec
from repro_torch.launch.mesh import AbstractMesh, make_local_mesh, production_shape
from repro_torch.models import LM
from repro_torch.models.layers import map_specs
from repro_torch.models.transformer import cache_axes, param_specs


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _axes_of(leaf):
    return leaf.axes if isinstance(leaf, RefParamSpec) else leaf


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_spec_for_equals_reference_on_every_leaf(arch):
    ref_cfg, cfg = get_config(arch), port_get_config(arch)
    ref_model = RefLM(ref_cfg)
    ref_tree = {"params": ref_model.param_specs()}
    tree = {"params": map_specs(lambda s: s.axes, param_specs(cfg))}
    if ref_cfg.decoder:
        ref_tree["cache"] = ref_model.cache_axes()
        tree["cache"] = cache_axes(cfg)
    ref_leaves = {p: _axes_of(v) for p, v in _leaves(ref_tree)}
    leaves = dict(_leaves(tree))
    assert leaves == ref_leaves
    for multi in (False, True):
        shape, names = production_shape(multi)
        for sname, cell in SHAPES.items():
            if not cell_applicable(ref_cfg, sname)[0]:
                continue
            kw = dict(global_batch=cell.global_batch, seq=cell.seq_len, kind=cell.kind)
            _, ref_rules, _ = ref_best_rules(ref_cfg, JaxAbstractMesh(shape, names), **kw)
            _, rules, _ = best_rules(cfg, AbstractMesh(shape, names), **kw)
            assert rules.table == ref_rules.table
            for path, axes in leaves.items():
                got = rules.spec_for(axes)
                assert isinstance(got, PartitionSpec)
                assert tuple(got) == tuple(ref_rules.spec_for(ref_leaves[path])), (path, sname, multi)


@pytest.mark.parametrize(
    "table,axes",
    [
        ({"batch": ("pod", "data"), "ffn": "model"}, ("batch", "seq", "ffn")),
        ({"a": "model", "b": "model"}, ("a", "b")),
        ({"batch": ("data", "model"), "embed": "model"}, ("batch", "embed", None)),
        ({"embed": ("data", "pod")}, (None, "unknown", "embed")),
    ],
)
def test_spec_for_basic_tables_equal_reference(table, axes):
    assert tuple(ShardingRules(None, table).spec_for(axes)) == tuple(RefRules(None, table).spec_for(axes))


def test_use_rules_nests_and_restores():
    outer = ShardingRules(None, {"batch": "data"})
    inner = ShardingRules(None, {"batch": "model"})
    assert current_rules() is None and logical_to_spec("batch") == ()
    with use_rules(outer):
        assert logical_to_spec("batch", None) == PartitionSpec("data", None)
        with use_rules(inner):
            assert current_rules() is inner
            assert logical_to_spec("batch") == ("model",)
        assert current_rules() is outer
    assert current_rules() is None


def test_constrain_is_a_noop_without_rules_or_mesh_and_checks_rank():
    x = torch.ones(4, 4)
    assert constrain(x, "batch", None) is x
    with use_rules(ShardingRules(None, {"batch": "data"})):
        assert constrain(x, "batch", None) is x
    with use_rules(ShardingRules(AbstractMesh((1, 1), ("data", "model")), {"batch": "data"})):
        with pytest.raises(ValueError):
            constrain(x, "batch")


def test_sharding_for_gives_placements_per_mesh_dim():
    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    rules = ShardingRules(mesh, {"batch": ("pod", "data"), "ffn": "model", "embed": ("data", "pod")})
    assert rules.sharding_for(("batch", "seq", "ffn")) == (Shard(0), Shard(0), Shard(2))
    assert rules.sharding_for(("embed", "ffn")) == (Shard(0), Shard(0), Shard(1))
    assert rules.sharding_for((None, None)) == (Replicate(),) * 3
    assert ShardingRules(None, {}).sharding_for(("batch",)) is None
    assert param_shardings({"w": ("embed", "ffn"), "s": {"n": ("embed",)}}, rules) == {
        "w": (Shard(0), Shard(0), Shard(1)),
        "s": {"n": (Shard(0), Shard(0), Replicate())},
    }


@pytest.fixture(scope="module")
def gloo_mesh():
    """A 1 x 1 mesh over a one-rank gloo group, destroyed after this module."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        yield make_local_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_make_local_mesh_needs_a_group_of_its_size(gloo_mesh):
    assert gloo_mesh.mesh_dim_names == ("data", "model") and tuple(gloo_mesh.shape) == (1, 1)
    with pytest.raises(RuntimeError):
        make_local_mesh(2, 1, device="cpu")


def test_constrain_places_a_dtensor_on_the_mesh(gloo_mesh):
    x = torch.arange(24.0).reshape(4, 6)
    rules = ShardingRules(gloo_mesh, {"batch": "data", "ffn": "model"})
    with use_rules(rules):
        y = constrain(x, "batch", "ffn")
        assert isinstance(y, DTensor)
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert torch.equal(y.to_local(), x)
        z = constrain(y, None, "batch")
        assert tuple(z.placements) == (Shard(1), Replicate())
        assert torch.equal(z.full_tensor(), x)


def test_param_shardings_place_an_lm_bitwise(gloo_mesh):
    cfg = get_smoke("qwen2_5_3b")
    lm = LM(cfg, device="cpu")
    _, rules, _ = best_rules(cfg, gloo_mesh, global_batch=4, seq=32, kind="train")
    placements = param_shardings(map_specs(lambda s: s.axes, lm.param_specs()), rules)
    named = dict(_leaves(placements))
    for path, full in _leaves(lm.reference_tree(dict(lm.named_parameters()))):
        dt = distribute_tensor(full, gloo_mesh, named[path])
        assert tuple(dt.placements) == named[path]
        assert torch.equal(dt.to_local(), full), path
