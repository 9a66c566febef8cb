"""``repro_torch.distributed.autoshard`` against ``repro.distributed.autoshard``.

For every architecture x applicable input shape x production mesh, the
port's candidate tables, its argmin (name, table and every cost field) and
its per-candidate predictions equal the reference's exactly.  The
reference reads jax's ``AbstractMesh(shape, axis_names)``; the port reads
its own ``AbstractMesh`` and a ``DeviceMesh`` stand-in (a shape tuple and
``mesh_dim_names``: a real 256-rank mesh needs the dry-run's fake group).
"""

import dataclasses
from types import SimpleNamespace

import pytest
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import ALL_ARCHS, SHAPES, cell_applicable, get_config
from repro.distributed import autoshard as ref_autoshard
from repro_torch.configs import get_config as port_get_config
from repro_torch.distributed import autoshard
from repro_torch.launch.mesh import AbstractMesh, mesh_axes, production_shape

MESHES = {"single": production_shape(False), "multi": production_shape(True)}
CELLS = [
    (arch, shape, mesh)
    for arch in ALL_ARCHS
    for shape in SHAPES
    if cell_applicable(get_config(arch), shape)[0]
    for mesh in MESHES
]


def _port_meshes(mesh_kind):
    shape, names = MESHES[mesh_kind]
    return {
        "abstract": AbstractMesh(shape, names),
        "device_mesh": SimpleNamespace(shape=shape, mesh_dim_names=names),
    }


def _ref_mesh(mesh_kind):
    shape, names = MESHES[mesh_kind]
    return JaxAbstractMesh(shape, names)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_every_mesh_reads_as_the_same_axes(mesh_kind):
    want = dict(_ref_mesh(mesh_kind).shape)
    for mesh in _port_meshes(mesh_kind).values():
        assert mesh_axes(mesh) == want
        assert list(mesh_axes(mesh)) == list(want)


@pytest.mark.parametrize("arch,shape,mesh_kind", CELLS)
def test_autoshard_equals_reference(arch, shape, mesh_kind):
    cell = SHAPES[shape]
    kw = dict(global_batch=cell.global_batch, seq=cell.seq_len)
    ref_cfg, cfg = get_config(arch), port_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_mesh = _ref_mesh(mesh_kind)
    want_cands = {n: r.table for n, r in ref_autoshard.candidate_rules(ref_cfg, ref_mesh, **kw).items()}
    want_name, want_rules, want_cost = ref_autoshard.best_rules(ref_cfg, ref_mesh, kind=cell.kind, **kw)
    want_pred = ref_autoshard.predict_cell(ref_cfg, ref_mesh, kind=cell.kind, **kw)
    for mesh in _port_meshes(mesh_kind).values():
        cands = autoshard.candidate_rules(cfg, mesh, **kw)
        assert {n: r.table for n, r in cands.items()} == want_cands
        assert list(cands) == list(want_cands)
        name, rules, cost = autoshard.best_rules(cfg, mesh, kind=cell.kind, **kw)
        assert (name, rules.table) == (want_name, want_rules.table)
        assert dataclasses.asdict(cost) == dataclasses.asdict(want_cost)
        assert (cost.step_s, cost.bound) == (want_cost.step_s, want_cost.bound)
        assert autoshard.predict_cell(cfg, mesh, kind=cell.kind, **kw) == want_pred
