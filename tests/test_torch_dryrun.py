"""``repro_torch.launch.dryrun`` and ``roofline`` against the reference.

The dry-run runs in a subprocess, so its fake process group lives and dies
there: two smoke configs (dense qwen2.5, MoE granite) at ``train_4k`` on a
2 x 2 fake mesh.  Each record has the reference's keys; its rules,
strategy and predictions equal the reference's autoshard on the same
abstract mesh; its argument bytes equal the per-chip bytes worked out from
the reference's parameter specs and rules; its flops are within the bound
``roofline.flops_ratio`` states.  The roofline's arithmetic is fed the same
two records in both packages (the reference's ``run_cell`` patched), priced
on the v5e.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import SHAPES, get_smoke
from repro.distributed.autoshard import best_rules as ref_best_rules
from repro.distributed.autoshard import predict_cell as ref_predict_cell
from repro.models import LM as RefLM
from repro.configs import get_config as ref_get_config
from repro_torch.configs import get_config, get_smoke as port_get_smoke
from repro_torch.launch import roofline

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("qwen2_5_3b", "granite_moe_3b_a800m")
MESH = ((2, 2), ("data", "model"))
# the bound roofline.flops_ratio states for the dry-run's count
FLOPS_RATIO = (0.95, 2.0)
# the keys of the record repro.launch.dryrun.run_cell writes
REF_KEYS = {
    "arch", "shape", "mesh", "chips", "n_layers", "depth_override", "remat", "strategy", "rules",
    "status", "lower_s", "compile_s", "memory_analysis", "cost_analysis_flops", "cost_analysis_bytes",
    "cost_analysis", "collectives", "hlo_bytes", "model_params", "model_active_params", "tokens",
    "kind", "predicted",
}

_SCRIPT = """
import dataclasses, json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_smoke
from repro_torch.launch import dryrun
dryrun.init_fake_group(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {a: dryrun.run_cell(a, "train_4k", "single", overrides=dataclasses.asdict(get_smoke(a)), mesh=mesh)
       for a in sys.argv[1:]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, *ARCHS], env=env, capture_output=True, text=True, timeout=600
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _json(x):
    return json.loads(json.dumps(x))


def _ref_rules(arch):
    cfg = get_smoke(arch)
    cell = SHAPES["train_4k"]
    mesh = JaxAbstractMesh(*MESH)
    name, rules, cost = ref_best_rules(cfg, mesh, global_batch=cell.global_batch, seq=cell.seq_len, kind="train")
    return cfg, cell, mesh, name, rules, cost


@pytest.mark.parametrize("arch", ARCHS)
def test_record_has_the_reference_keys_and_autoshard(records, arch):
    rec = records[arch]
    assert set(rec) == REF_KEYS
    assert rec["status"] == "ok" and rec["chips"] == 4 and rec["kind"] == "train"
    assert set(rec["memory_analysis"]) == {
        "argument_size_bytes", "output_size_bytes", "temp_size_bytes", "generated_code_size_bytes"
    }
    assert set(rec["collectives"]) == {"bytes_by_kind", "count_by_kind", "total_bytes"}
    cfg, cell, mesh, name, rules, cost = _ref_rules(arch)
    assert rec["strategy"] == name
    assert rec["rules"] == _json(rules.table)
    assert rec["predicted"]["strategy_cost"] == {
        "compute_s": cost.compute_s, "memory_s": cost.memory_s, "collective_s": cost.collective_s, "bound": cost.bound
    }
    want = ref_predict_cell(ref_get_config(arch), mesh, global_batch=cell.global_batch, seq=cell.seq_len, kind="train")
    assert rec["predicted"]["candidates"] == _json(want)
    assert rec["model_params"] == cfg.n_params() and rec["tokens"] == cell.global_batch * cell.seq_len


def _local_bytes(shape, spec, sizes, elem_bytes):
    local = [
        math.ceil(d / math.prod(sizes[a] for a in ((p,) if isinstance(p, str) else p or ())))
        for d, p in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec)))
    ]
    return math.prod(local) * elem_bytes


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_the_reference_specs_per_chip(records, arch):
    """Parameters in their dtype, AdamW's m, v and master copy in fp32, its
    int32 step, and the int32 tokens and labels, each as the chip's shard."""
    cfg, cell, mesh, _, rules, _ = _ref_rules(arch)
    sizes = dict(mesh.shape)
    want = 4  # the optimizer's step
    for s in _leaves(RefLM(cfg).param_specs()):
        spec = rules.spec_for(s.axes)
        want += _local_bytes(s.shape, spec, sizes, np.dtype(jax.numpy.dtype(s.dtype)).itemsize)
        want += 3 * _local_bytes(s.shape, spec, sizes, 4)
    want += 2 * _local_bytes((cell.global_batch, cell.seq_len), rules.spec_for(("batch", "seq")), sizes, 4)
    assert records[arch]["memory_analysis"]["argument_size_bytes"] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_flops_are_within_the_stated_ratio(records, arch):
    rec = records[arch]
    cfg = port_get_smoke(arch)
    ratio = roofline.flops_ratio(rec["cost_analysis_flops"] * rec["chips"], cfg, SHAPES["train_4k"])
    assert FLOPS_RATIO[0] <= ratio <= FLOPS_RATIO[1], ratio
    assert rec["cost_analysis_bytes"] > 0
    assert rec["collectives"]["total_bytes"] == sum(rec["collectives"]["bytes_by_kind"].values())


def _hand_records(chips=256, remat="full"):
    mk = lambda f, b, c: {  # noqa: E731
        "chips": chips, "remat": remat, "cost_analysis_flops": f, "cost_analysis_bytes": b,
        "collectives": {"total_bytes": c, "bytes_by_kind": {"all-gather": c}},
    }
    return mk(3.25e13, 7.5e11, 2.2e10), mk(5.75e13, 1.25e12, 4.1e10)


@pytest.mark.parametrize("arch,shape", [("qwen2_5_3b", "train_4k"), ("mamba2_1_3b", "train_4k"),
                                        ("recurrentgemma_2b", "prefill_32k")])
def test_roofline_arithmetic_equals_reference(monkeypatch, arch, shape):
    jax.devices()  # the backend starts before the reference's launch modules set XLA_FLAGS
    if "XLA_FLAGS" in os.environ:
        monkeypatch.setenv("XLA_FLAGS", os.environ["XLA_FLAGS"])
    else:
        monkeypatch.delenv("XLA_FLAGS", raising=False)
    import repro.launch.dryrun as ref_dryrun
    import repro.launch.roofline as ref_roofline
    from repro_torch.launch import dryrun

    rec1, rec2 = _hand_records()
    by_depth = lambda *a, depth_override=None, **k: rec1 if depth_override == len(  # noqa: E731
        get_config(arch).block_types) else rec2
    monkeypatch.setattr(ref_dryrun, "run_cell", by_depth)
    monkeypatch.setattr(dryrun, "run_cell", by_depth)
    want = ref_roofline.analyse_cell(arch, shape)
    got = roofline.analyse_cell(arch, shape, chip=roofline.ChipRates.of_v5e())
    terms = roofline.roofline_terms(rec1, rec2, get_config(arch), SHAPES[shape], roofline.ChipRates.of_v5e())
    for key, v in want.items():
        if isinstance(v, float):
            assert got[key] == pytest.approx(v, rel=1e-12), key
            assert terms[key] == pytest.approx(v, rel=1e-12), key
        elif key not in ("overrides", "suggestion"):
            assert got[key] == v, key
    assert got["suggestion"] == want["suggestion"]
    assert roofline.fmt_row(got) == ref_roofline.fmt_row(want)
    h100 = roofline.roofline_terms(rec1, rec2, get_config(arch), SHAPES[shape], roofline.ChipRates.of_h100())
    assert h100["compute_s"] < terms["compute_s"]  # 989 vs 197 TFLOP/s


def test_chip_rates_are_the_data_sheets():
    from repro.targets.tpu_v5e import V5E

    v5e = roofline.ChipRates.of_v5e()
    assert (v5e.peak_flops, v5e.hbm_bytes_per_s) == (V5E.peak_flops_bf16, V5E.hbm_bytes_per_s)
    assert v5e.collective_bytes_per_s == V5E.ici_link_bytes_per_s * V5E.ici_links_per_axis
    h100 = roofline.ChipRates.of_h100()
    assert (h100.peak_flops, h100.hbm_bytes_per_s, h100.collective_bytes_per_s) == (989e12, 3.35e12, 900e9)


def test_attention_flops_follow_the_config():
    cell = SHAPES["train_4k"]
    qwen = get_config("qwen2_5_3b")
    assert roofline.attention_flops(qwen, cell) == (
        12.0 * qwen.n_layers * qwen.n_heads * qwen.head_dim_ * cell.seq_len * cell.global_batch * cell.seq_len
    )
    assert roofline.attention_flops(get_config("mamba2_1_3b"), cell) == 0.0
    assert roofline.attention_flops(qwen, SHAPES["decode_32k"]) == 0.0
    assert dataclasses.asdict(port_get_smoke("qwen2_5_3b")) == dataclasses.asdict(get_smoke("qwen2_5_3b"))


@pytest.mark.parametrize("shape,names,table,want", [
    ((16, 16), ("data", "model"), {"batch": ("data", "model"), "embed": ("data", "model"), "heads": None},
     [("data", "model")]),
    ((16, 16), ("data", "model"), {"batch": ("data",), "heads": "model", "ffn": "model"}, []),
    ((2, 16, 16), ("pod", "data", "model"), {"batch": ("pod", "data"), "embed": ("data", "pod"), "heads": "model"},
     [("pod", "data")]),
    ((16, 16), ("data", "model"), {"batch": ("data", "model"), "embed": "data"}, []),
])
def test_joint_axes_are_the_axes_only_used_together(shape, names, table, want):
    from repro_torch.distributed import ShardingRules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh

    assert dryrun._joint_axes(ShardingRules(AbstractMesh(shape, names), table)) == want
