"""The plain reference, the graphs the harness builds and the need counts,
held against the port's own nets and CPU interpreter."""

import inspect
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench import data, spec
from bench.reference import cnn_int, counts
from conftest import CHECKOUT
from repro_torch.cnn.execute import execute_graph
from repro_torch.cnn.nets import dae_graph, mobilenet_v1_graph
from repro_torch.core import dispatch

CONFIGS = {"mobilenetv1_025_vww": mobilenet_v1_graph, "dae_toycar": dae_graph}
MACS = {"mobilenetv1_025_vww": 7_489_664, "dae_toycar": 264_192}
chain = spec.named(spec.BENCH, "graphs", "cnn_chain")
build_graph, program_params = chain.build_graph, chain.program_params


def config(name: str) -> dict:
    return json.loads((CHECKOUT / "bench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_graph_is_the_ports_net(name):
    ours, theirs = build_graph(config(name)), CONFIGS[name]()
    assert [(n.name, n.op, n.inputs, dict(n.attrs)) for n in ours.nodes] == [
        (n.name, n.op, n.inputs, dict(n.attrs)) for n in theirs.nodes
    ]
    assert ours.inputs == theirs.inputs and ours.outputs == theirs.outputs


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("rows", [1, 3])
def test_reference_equals_the_ports_interpreter(name, rows):
    cfg = config(name)
    drawn = data.draw(cfg, 2**31 + 7, rows, torch.device("cpu"))
    x = torch.cat(drawn.pool)
    got = execute_graph(build_graph(cfg), program_params(cfg, drawn), {"x": x.float()}, device="cpu")
    (out,) = got.values()
    want = cnn_int.forward(cfg["layers"], drawn.reference_params(), x.numpy())
    np.testing.assert_array_equal(out.numpy().astype(np.int64), want.reshape(out.shape))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_counts(name):
    cfg = config(name)
    assert counts.macs(cfg["layers"], cfg["input"]["shape"]) == MACS[name] == cfg["macs"]
    mac_layers = [layer for layer in cfg["layers"] if layer["op"] in cnn_int.MAC_OPS]
    shapes = counts.shapes(cfg["layers"], cfg["input"]["shape"])
    params = sum(counts.layer_counts(layer, i, o, 0)["bytes"] for layer, (i, o) in zip(cfg["layers"], shapes))
    assert params == cfg["weight_bytes"] + cfg["bias_bytes"]
    assert cfg["bias_bytes"] == 4 * sum(layer["C"] if layer["op"] == "dwconv2d" else layer["K"] for layer in mac_layers)
    one, sixteen = (counts.need_s(cfg["layers"], cfg["input"]["shape"], r, 1.979e15, 3.35e12) for r in (1, 16))
    assert 0 < one < sixteen < 16 * one


def test_need_of_one_dense_layer():
    layer = {"op": "dense", "K": 128, "C": 640, "relu": True}
    c = counts.layer_counts(layer, (640,), (128,), 4)
    assert c == {"macs": 4 * 128 * 640, "ops": 2 * 4 * 128 * 640, "bytes": 128 * 640 + 4 * 128 + 4 * (640 + 128)}


def test_dispatch_settings_are_the_ports_defaults():
    defaults = {k: p.default for k, p in inspect.signature(dispatch).parameters.items()}
    for name in CONFIGS:
        for k, v in config(name)["dispatch"].items():
            assert defaults[k] == v, (name, k)


def test_rounding_is_half_to_even():
    acc = np.array([-48, -40, -24, -8, 8, 24, 40, 48, 7, -7])
    np.testing.assert_array_equal(cnn_int.round_half_even_shift(acc, 4), [-3, -2, -2, 0, 0, 2, 2, 3, 0, 0])
    np.testing.assert_array_equal(cnn_int.round_half_even_div(np.array([13, 14, -13]), 4), [3, 4, -3])


def test_shifts_keep_activations_alive():
    """Through the whole depth, about half of each layer's outputs are zero
    (the ReLU) and few clip: neither vanish nor saturate."""
    for name in CONFIGS:
        cfg = config(name)
        drawn = data.draw(cfg, 11, 16, torch.device("cpu"))
        h = torch.cat(drawn.pool).numpy().astype(np.int64)
        for layer, p in zip(cfg["layers"], drawn.reference_params()):
            h = cnn_int.forward([layer], [p], h)
            if p is not None and layer["relu"]:
                assert 0.3 < np.mean(h == 0) < 0.7, (name, layer)
                assert np.mean(h == 127) < 0.1, (name, layer)


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of the benchmark's command on the card: correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "dae_toycar.single", "--seed", str(2**31 + 5),
         "--seconds", "2", "--trace", "0"],
        cwd=CHECKOUT, capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks" and out.stderr.strip().splitlines()[-1].startswith("check ")
