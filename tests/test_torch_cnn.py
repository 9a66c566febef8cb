"""The port's interpreter (repro_torch.cnn.execute) on the CPU is
bit-exact with the JAX interpreter (repro.cnn.execute_graph)."""

import numpy as np
import pytest
import torch

import repro.cnn
import repro.core
import repro_torch.cnn
import repro_torch.core
from _torch_port import NETS, io, port_graph, ref_graph, ref_outputs
from repro.core.graph import fold_requant_div as ref_fold
from repro_torch.core.graph import fold_requant_div as port_fold


def _both(spec, inputs, outputs, name="g"):
    """The same hand-built graph in both packages' IR."""
    ref = repro.core.Graph(name, [repro.core.Node(*n) for n in spec], inputs, outputs)
    port = repro_torch.core.Graph(name, [repro_torch.core.Node(*n) for n in spec], inputs, outputs)
    return ref, port


def _assert_same(ref_g, port_g, params, x):
    want = repro.cnn.execute_graph(ref_g, params, x)
    got = repro_torch.cnn.execute_graph(port_g, params, x, device="cpu")
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        assert np.array_equal(got[k].numpy(), w), k


@pytest.mark.parametrize("net", NETS)
def test_execute_graph_bit_exact_on_mlperf_tiny(net):
    params, x = io(net)
    got = repro_torch.cnn.execute_graph(port_graph(net), params, x, device="cpu")
    for k, want in ref_outputs(net).items():
        assert got[k].dtype == torch.float32
        assert np.array_equal(got[k].numpy(), want)


@pytest.mark.parametrize("net", NETS)
def test_init_graph_params_matches_reference(net):
    want = repro.cnn.init_graph_params(ref_graph(net), seed=3)
    got = repro_torch.cnn.init_graph_params(port_graph(net), seed=3)
    assert want.keys() == got.keys()
    for name in want:
        assert want[name].keys() == got[name].keys()
        for k in want[name]:
            assert np.asarray(got[name][k]).dtype == np.asarray(want[name][k]).dtype
            assert np.array_equal(got[name][k], want[name][k]), (name, k)


def test_params_to_torch_keeps_values_and_layouts():
    g = port_graph("DSCNN")
    params = repro_torch.cnn.init_graph_params(g)
    tp = repro_torch.cnn.params_to_torch(params, "cpu")
    assert tp.keys() == params.keys()
    for name, p in params.items():
        for k, v in p.items():
            if np.ndim(v) == 0:
                assert isinstance(tp[name][k], float) and tp[name][k] == float(v)
            else:
                t = tp[name][k]
                assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
                assert tuple(t.shape) == v.shape  # HWIO / (K, C) / (K,) kept
                assert np.array_equal(t.numpy(), v)
    # idempotent: converted params pass through untouched
    again = repro_torch.cnn.params_to_torch(tp, "cpu")
    for name, p in tp.items():
        for k, v in p.items():
            assert again[name][k] is v or again[name][k] == v
    # 64-bit numpy narrows like the JAX reference
    t64 = repro_torch.cnn.params_to_torch({"n": {"w": np.ones((2, 2), np.float64)}}, "cpu")
    assert t64["n"]["w"].dtype == torch.float32


def test_unfolded_requant_chain_ops_match_reference():
    """mul/div/rshift/clip arithmetic, attrs and param overrides
    (tests/test_backend.py::test_unfolded_requant_chain_ops_compute)."""
    spec = [
        ("m", "mul", ("x",), {"scale": 3.0}),
        ("d", "div", ("m",), {"divisor": 4.0}),
        ("s", "rshift", ("d",), {"shift": 1.0}),
        ("c", "clip", ("s",), {"clip_min": -8, "clip_max": 8}),
    ]
    ref_g, port_g = _both(spec, {"x": (4,)}, ("c",))
    x = {"x": np.array([40.0, -40.0, 4.0, 2.0], "float32")}
    _assert_same(ref_g, port_g, {}, x)
    _assert_same(ref_g, port_g, {"m": {"scale": np.float32(1.0)}}, x)


def test_folded_requant_with_scale_and_addend_matches_reference():
    spec = [
        ("m", "mul", ("x",), {"scale": 3.0}),
        ("a", "add", ("m",), {"addend": 4.0}),
        ("s", "rshift", ("a",), {"shift": 2.0}),
    ]
    ref_g, port_g = _both(spec, {"x": (7,)}, ("s",))
    ref_f, port_f = ref_fold(ref_g), port_fold(port_g)
    assert [n.op for n in port_f.nodes] == [n.op for n in ref_f.nodes] == ["requant"]
    x = {"x": np.array([10.0, -9.0, 100.0, 2.0, -2.0, 6.0, -6.0], "float32")}
    _assert_same(ref_f, port_f, {}, x)
    params = repro.cnn.init_graph_params(ref_f)
    _assert_same(ref_f, port_f, params, x)
    assert repro_torch.cnn.init_graph_params(port_f).keys() == params.keys()


@pytest.mark.parametrize("op", ["add", "mul"])
@pytest.mark.parametrize("arity", [2, 3, 4])
def test_nary_join_matches_reference(op, arity):
    names = [f"x{i}" for i in range(arity)]
    spec = [("j", op, tuple(names), {}), ("r", "requant", ("j",), {})]
    ref_g, port_g = _both(spec, {n: (1, 3, 3, 2) for n in names}, ("r",))
    rng = np.random.default_rng(arity)
    x = {n: rng.integers(-20, 20, (1, 3, 3, 2)).astype(np.float32) for n in names}
    _assert_same(ref_g, port_g, {"r": {"shift": np.float32(3.0)}}, x)


def test_concat_relu_maxpool_avgpool_match_reference():
    spec = [
        ("c", "concat", ("a", "b"), {}),
        ("r", "relu", ("c",), {}),
        ("mp", "maxpool", ("r",), {"FY": 2, "FX": 3}),
        ("ap", "avgpool", ("mp",), {}),
        ("d", "div", ("ap", "ap2"), {}),
        ("k", "identity", ("d",), {}),
    ]
    ref_g, port_g = _both(spec, {"a": (2, 5, 7, 3), "b": (2, 5, 7, 2), "ap2": (2, 1, 1, 5)}, ("mp", "ap", "k"))
    rng = np.random.default_rng(5)
    x = {
        "a": rng.integers(-128, 128, (2, 5, 7, 3)).astype(np.float32),
        "b": rng.integers(-128, 128, (2, 5, 7, 2)).astype(np.float32),
        "ap2": rng.integers(1, 9, (2, 1, 1, 5)).astype(np.float32),
    }
    _assert_same(ref_g, port_g, {}, x)


def test_dense_bias_requant_head_matches_reference():
    spec = [
        ("fc", "dense", ("x",), {"K": 6, "C": 12}),
        ("b", "bias_add", ("fc",), {"K": 6}),
        ("q", "requant", ("b",), {"shift": 4}),
    ]
    ref_g, port_g = _both(spec, {"x": (3, 1, 1, 12)}, ("q",))
    params = repro.cnn.init_graph_params(ref_g, seed=9)
    x = {"x": np.random.default_rng(9).integers(-128, 128, (3, 1, 1, 12)).astype(np.float32)}
    _assert_same(ref_g, port_g, params, x)


def test_unknown_op_raises():
    _, port_g = _both([("z", "softmax", ("x",), {})], {"x": (2,)}, ("z",))
    with pytest.raises(NotImplementedError):
        repro_torch.cnn.execute_graph(port_g, {}, {"x": np.zeros(2, np.float32)}, device="cpu")
