"""The PyTorch port imports neither JAX nor the reference package, and its
entry points default to the CUDA device without falling back."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.backend import lower
from repro_torch.cnn import conv_block_graph, execute_graph
from repro_torch.core import dispatch
from repro_torch.configs import get_smoke
from repro_torch.kernels import matmul_requant
from repro_torch.launch import serve as serve_cli
from repro_torch.models import LM

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), leaked)
assert not leaked, leaked
assert {"repro_torch.backend.lower", "repro_torch.kernels.matmul_requant",
        "repro_torch.obs.trace", "repro_torch.targets.registry",
        "repro_torch.kernels.flash_attention", "repro_torch.models.transformer",
        "repro_torch.configs.qwen2_5_3b", "repro_torch.serving.engine",
        "repro_torch.launch.serve", "repro_torch.pipeline.schedule",
        "repro_torch.calibrate.profile", "repro_torch.kernels.moe_gmm",
        "repro_torch.kernels.ssd_scan", "repro_torch.models.moe",
        "repro_torch.models.ssd", "repro_torch.models.rglru",
        "repro_torch.kernels.rglru_scan", "repro_torch.pipeline.runtime",
        "repro_torch.serve.queue", "repro_torch.serve.batching", "repro_torch.serve.engine",
        "repro_torch.targets.h100", "repro_torch.targets.tpu_v5e",
        "repro_torch.calibrate.fit", "repro_torch.calibrate.microbench", "repro_torch.calibrate.__main__",
        "repro_torch.fuzz.generate", "repro_torch.fuzz.oracle", "repro_torch.fuzz.corpus",
        "repro_torch.fuzz.shrink", "repro_torch.fuzz.__main__", "repro_torch.obs.__main__",
        "repro_torch.training.optimizer", "repro_torch.training.train_loop", "repro_torch.training.checkpoint",
        "repro_torch.training.fault_tolerance", "repro_torch.data.pipeline", "repro_torch.distributed.compression",
        "repro_torch.launch.train", "repro_torch.kernels.ops", "repro_torch.distributed.sharding",
        "repro_torch.distributed.autoshard", "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
        "repro_torch.launch.roofline"} <= set(names)
"""

# the entry points, imported in a fresh interpreter
_ENTRY_PROBE = """
import sys
import repro_torch.models, repro_torch.serving, repro_torch.launch.serve
import repro_torch.configs, repro_torch.pipeline, repro_torch.calibrate
import repro_torch.serve, repro_torch.targets.h100, repro_torch.fuzz
import repro_torch.calibrate.__main__, repro_torch.fuzz.__main__, repro_torch.obs.__main__
import repro_torch.training, repro_torch.data, repro_torch.distributed, repro_torch.launch.train
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
"""

# the last reference modules' counterparts, imported in a fresh interpreter:
# no jax, no repro, no fake process group (the dry-run's lives only in its
# CLI), and no environment set
_DISTRIBUTED_PROBE = """
import os, sys
env = dict(os.environ)
import repro_torch.kernels.ops, repro_torch.distributed.sharding, repro_torch.distributed.autoshard
import repro_torch.launch.mesh, repro_torch.launch.dryrun, repro_torch.launch.roofline
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
assert "torch.testing._internal.distributed.fake_pg" not in sys.modules
assert dict(os.environ) == env
import torch.distributed as dist
assert not dist.is_initialized()
"""


@pytest.mark.parametrize("probe", [_PROBE, _ENTRY_PROBE, _DISTRIBUTED_PROBE],
                         ids=["every-module", "lm-entry-points", "distributed-and-launch"])
def test_import_loads_no_jax_and_no_reference(probe):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-c", probe], env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device would work")


def test_lower_defaults_to_cuda_and_raises_without_card():
    _no_card()
    mapped = dispatch(conv_block_graph(IX=8, IY=8, C=8, K=8), "gap9", budget=300)
    with pytest.raises((AssertionError, RuntimeError)):
        lower(mapped)
    assert lower(mapped, device="cpu").device == torch.device("cpu")


def test_execute_graph_defaults_to_cuda_and_raises_without_card():
    _no_card()
    g = conv_block_graph(IX=4, IY=4, C=2, K=2)
    x = {"x": np.zeros((1, 4, 4, 2), np.float32)}
    with pytest.raises((AssertionError, RuntimeError)):
        execute_graph(g, {}, x)


@pytest.mark.parametrize(
    "kwargs,exc",
    [
        ({"rounding": "up"}, ValueError),
        ({"shift": 32}, ValueError),
        ({"shift": -1, "rounding": "floor"}, ValueError),
        ({"a_dtype": torch.int32}, TypeError),
        ({"bias_len": 3}, ValueError),
    ],
)
def test_matmul_requant_rejects_bad_arguments(kwargs, exc):
    kw = dict(kwargs)
    a = torch.zeros((2, 8), dtype=kw.pop("a_dtype", torch.int8))
    w = torch.zeros((8, 4), dtype=torch.int8)
    bias = torch.zeros(kw.pop("bias_len", 4), dtype=torch.int32)
    with pytest.raises(exc):
        matmul_requant(a, w, torch.ones(4, dtype=torch.int32), bias, **kw)


def test_matmul_requant_on_cpu_does_not_count_launches():
    before = matmul_requant.launches
    a = torch.ones((1, 8), dtype=torch.int8)
    w = torch.ones((8, 4), dtype=torch.int8)
    out = matmul_requant(a, w, torch.ones(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32), shift=0)
    assert out.tolist() == [[8, 8, 8, 8]]
    assert matmul_requant.launches == before


def test_lm_defaults_to_cuda_and_raises_without_card():
    _no_card()
    cfg = get_smoke("qwen2_5_3b")
    with pytest.raises((AssertionError, RuntimeError)):
        LM(cfg)
    assert LM(cfg, device="cpu").device == torch.device("cpu")


def test_serve_engine_and_cli_default_to_cuda_and_raise_without_card():
    _no_card()
    with pytest.raises((AssertionError, RuntimeError)):
        serve_cli.build_engine(get_smoke("qwen2_5_3b"))
    with pytest.raises((AssertionError, RuntimeError)):
        serve_cli.main(["--arch", "qwen2_5_3b", "--smoke"])
    assert serve_cli.build_engine(get_smoke("qwen2_5_3b"), "cpu").model.device == torch.device("cpu")
