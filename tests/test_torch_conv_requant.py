"""The fused conv segment on the CPU: ``conv_requant`` (its plain version)
against the JAX package's ``tiled_conv2d`` followed by the interpreter's
``bias_add``, ``requant`` and ``relu``, tolerance 0, at every distinct conv
layer shape of MobileNetV1-0.25 and DS-CNN's 10x4 stride-2 first layer,
batch 1 and 16, with the band height, ReLU, round-half-even ties and the
int8 clip pinned; and the lowering that gives a ``tiled_conv`` segment the
kernel (``meta["kernel"]``, the ``lower.conv.fused`` counter), issues
nothing but views around it, keeps the banded executor where the chain is
not the kernel's, and stays bit-exact with the interpreter."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cnn.execute as jax_execute
import repro.core
from _torch_port import io, one_torch_thread, port_compiled, port_graph, ref_outputs  # noqa: F401
from repro.kernels import tiled_conv2d as jax_tiled_conv2d
from repro_torch import obs
from repro_torch.backend import compile_aot
from repro_torch.cnn import conv_block_graph, execute_graph, init_graph_params, params_to_torch
from repro_torch.core import Graph, Node, dispatch
from repro_torch.kernels import conv_requant, conv_requant_plain
from repro_torch.kernels.conv_requant import supports
from repro_torch.targets import make_h100_target

lower_mod = importlib.import_module("repro_torch.backend.lower")

# (IY, IX, C, K, FY, FX, stride, depthwise): every distinct conv layer of
# MobileNetV1-0.25 at 96x96 (stem, then each depthwise and pointwise
# shape of its 13 blocks) and DS-CNN's first layer (10x4, stride 2, the
# asymmetric SAME padding)
MOBILENET = [(96, 96, 3, 8, 3, 3, 2, False)] + [
    shape
    for c, k, hw, s in ((8, 16, 48, 1), (16, 32, 48, 2), (32, 32, 24, 1), (32, 64, 24, 2), (64, 64, 12, 1),
                        (64, 128, 12, 2), (128, 128, 6, 1), (128, 256, 6, 2), (256, 256, 3, 1))
    for shape in ((hw, hw, c, c, 3, 3, s, True), (hw // s, hw // s, c, k, 1, 1, 1, False))
]
DSCNN_FIRST = (49, 10, 1, 64, 10, 4, 2, False)
SHAPES = MOBILENET + [DSCNN_FIRST]


def _operands(shape, batch: int, seed: int):
    iy, ix, c, k, fy, fx, _, dw = shape
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (batch, iy, ix, c)).astype(np.float32)
    w = rng.integers(-128, 128, (fy, fx, 1, c) if dw else (fy, fx, c, k)).astype(np.float32)
    b = rng.integers(-3000, 3000, (c if dw else k,)).astype(np.float32)
    return x, w, b


def _jax_segment(x, w, b, *, stride, depthwise, shift, relu, block_oy=0):
    """The reference lowering's conv segment: the banded ``lax.conv`` and
    the interpreter's ops for the chain, on the CPU."""
    y = jax_tiled_conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride, block_oy=block_oy,
                         feature_groups=x.shape[-1] if depthwise else 1)
    if b is not None:
        y = jax_execute.apply_node(repro.core.Node("b", "bias_add", ("c",)), {"b": b}, [y])
    y = jax_execute.apply_node(repro.core.Node("q", "requant", ("b",)), {"shift": np.float32(shift)}, [y])
    if relu:
        y = jax_execute.apply_node(repro.core.Node("r", "relu", ("q",)), {}, [y])
    return np.asarray(y)


def _plain(x, w, b, **kw):
    return conv_requant(torch.from_numpy(x), torch.from_numpy(w), None if b is None else torch.from_numpy(b),
                        **kw).numpy()


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:6])) + f"s{s[6]}{'dw' if s[7] else ''}")
def test_plain_matches_jax_segment_at_every_layer_shape(shape, batch):
    x, w, b = _operands(shape, batch, seed=sum(shape[:6]) + batch)
    kw = dict(stride=shape[6], depthwise=shape[7], shift=5)
    for relu in (True, False):
        got = _plain(x, w, b, relu=relu, **kw)
        assert got.dtype == np.float32
        assert got.shape == (batch, -(-shape[0] // shape[6]), -(-shape[1] // shape[6]), w.shape[3])
        assert np.array_equal(got, _jax_segment(x, w, b, relu=relu, **kw)), relu


@pytest.mark.parametrize("block_oy", [0, 1, 3, -1])  # -1: OY
@pytest.mark.parametrize("shape", [MOBILENET[0], MOBILENET[3], MOBILENET[10], DSCNN_FIRST],
                         ids=["stem", "dw48s2", "pw12", "dscnn10x4s2"])
def test_block_oy_does_not_change_the_result(shape, block_oy):
    x, w, b = _operands(shape, 1, seed=11)
    oy = -(-shape[0] // shape[6])
    block_oy = oy if block_oy < 0 else block_oy
    kw = dict(stride=shape[6], depthwise=shape[7], shift=4, relu=True)
    got = _plain(x, w, b, block_oy=block_oy, **kw)
    assert np.array_equal(got, _jax_segment(x, w, b, block_oy=block_oy, **kw))
    assert np.array_equal(got, _plain(x, w, b, **kw))


@pytest.mark.parametrize("shift", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("depthwise", [False, True])
def test_round_half_even_at_exact_ties(shift, depthwise):
    """A 1x1 conv of weight 1 makes each sum its input: with the biases,
    the sums cover whole residues mod 2^shift, so every half-way tie (an
    odd multiple of 2^(shift-1)) is met, both below and above zero."""
    c = 16
    x = np.arange(-128, 128, dtype=np.float32).reshape(1, 16, 16, 1).repeat(c, axis=3)
    w = np.ones((1, 1, 1, c) if depthwise else (1, 1, c, c), np.float32)
    if not depthwise:  # one input channel per output channel
        w = np.eye(c, dtype=np.float32)[None, None]
    b = np.arange(c, dtype=np.float32) * 5 - 40
    kw = dict(stride=1, depthwise=depthwise, shift=shift, relu=False)
    got = _plain(x, w, b, **kw)
    assert np.array_equal(got, _jax_segment(x, w, b, **kw))
    if shift > 0:
        sums = (x + b).astype(np.int64)
        ties = sums % (1 << shift) == 1 << (shift - 1)
        assert ties.sum() > 100 and (sums[ties] < 0).any() and (sums[ties] > 0).any()
        q = got[ties].astype(np.int64)
        inside = np.abs(q) < 127  # not clipped: the tie went to the even neighbour
        assert inside.any() and (q[inside] % 2 == 0).all()


@pytest.mark.parametrize("shape", [MOBILENET[0], MOBILENET[1], MOBILENET[-1]], ids=["stem", "dw48", "pw3"])
def test_sums_clip_at_both_ends(shape):
    x, w, b = _operands(shape, 1, seed=3)
    kw = dict(stride=shape[6], depthwise=shape[7], shift=0, relu=False)
    got = _plain(x, w, b, **kw)
    assert (got == -128).any() and (got == 127).any()
    assert np.array_equal(got, _jax_segment(x, w, b, **kw))
    relu = _plain(x, w, b, **{**kw, "relu": True})
    assert relu.min() == 0 and (relu == 127).any()
    assert np.array_equal(relu, _jax_segment(x, w, b, **{**kw, "relu": True}))


def test_plain_version_without_bias_and_on_a_strided_view():
    x, w, _ = _operands(MOBILENET[2], 2, seed=5)
    view = torch.from_numpy(x).permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)  # NHWC, W-major in memory
    kw = dict(stride=1, depthwise=False, shift=6, relu=True)
    got = conv_requant(view, torch.from_numpy(w), None, **kw).numpy()
    assert np.array_equal(got, _jax_segment(x, w, None, **kw))


def test_entry_rejects_bad_arguments():
    x = torch.zeros((1, 6, 6, 8))
    w = torch.zeros((3, 3, 8, 4))
    with pytest.raises(ValueError):
        conv_requant(x, torch.zeros((3, 3, 7, 4)))
    with pytest.raises(ValueError):
        conv_requant(x, w, depthwise=True)
    with pytest.raises(ValueError):
        conv_requant(x, w, torch.zeros(3))
    with pytest.raises(TypeError):
        conv_requant(x.to(torch.int8), w)
    with pytest.raises(ValueError):
        conv_requant(x, w, shift=32)
    with pytest.raises(ValueError):
        conv_requant(x, w, stride=0)
    with pytest.raises(ValueError):  # 3 x 3 x 16384 taps could overflow int32
        conv_requant(torch.zeros((1, 3, 3, 1 << 14)), torch.zeros((3, 3, 1 << 14, 1)))


def test_supports_bounds_the_int32_sums_and_the_depthwise_taps():
    assert supports(10, 4, 1, depthwise=False) and supports(3, 3, 14563, depthwise=False)
    assert not supports(3, 3, 14564, depthwise=False)  # 9 x 14564 >= 2^17
    assert supports(64, 64, 1, depthwise=False)  # a dense reduction is staged in chunks
    assert supports(12, 16, 1, depthwise=True) and not supports(13, 15, 1, depthwise=True)


def test_cpu_call_launches_no_kernel():
    x, w, b = _operands(MOBILENET[2], 1, seed=1)
    before = conv_requant.launches
    conv_requant_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    _plain(x, w, b)
    assert conv_requant.launches == before


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------


def _lowered(graph, target, counters: dict | None = None):
    mapped = dispatch(graph, target, budget=300)
    before = dict(obs.metrics_dict()["counters"])
    cm = lower_mod.lower(mapped, device="cpu")
    after = obs.metrics_dict()["counters"]
    if counters is not None:
        counters.update({k: after.get(k, 0) - before.get(k, 0) for k in ("lower.conv.fused", "lower.route.tiled_conv")})
    return cm


def _rebuilt(graph, **requant_attrs) -> Graph:
    """``graph`` with ``requant_attrs`` added to each requant node and,
    with ``elem_bytes=None``, without any node's ``elem_bytes``."""
    nodes = []
    for n in graph.nodes:
        attrs = dict(n.attrs)
        if requant_attrs.get("elem_bytes", 0) is None:
            attrs.pop("elem_bytes", None)
        if n.op == "requant":
            attrs.update({k: v for k, v in requant_attrs.items() if k != "elem_bytes"})
        nodes.append(Node(n.name, n.op, n.inputs, attrs))
    return Graph(graph.name, nodes, graph.inputs, graph.outputs)


def _check_bit_exact(cm, graph, params: dict, x: dict) -> None:
    want = execute_graph(graph, params_to_torch(params, "cpu"), x, device="cpu")
    got = cm.run(params, x)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _no_bias_graph() -> Graph:
    """conv2d, requant, relu: a chain without bias_add (the conv segment
    takes conv2d and requant)."""
    geom = dict(B=1, K=8, C=4, OY=8, OX=8, FY=3, FX=3, stride=1, elem_bytes=1)
    nodes = [Node("c", "conv2d", ("x",), geom), Node("q", "requant", ("c",), geom), Node("r", "relu", ("q",), geom)]
    return Graph("no_bias", nodes, {"x": (1, 8, 8, 4)}, ("r",))


@pytest.mark.parametrize("net,target", [("MobileNet", "h100"), ("conv_block", "gap9"), ("dw_block", "gap9"),
                                        ("no_bias", "diana")])
def test_lowering_gives_int8_conv_chains_the_kernel(net, target):
    if net == "MobileNet":
        graph = port_graph(net)
    elif net == "no_bias":
        graph = _no_bias_graph()
    else:
        graph = conv_block_graph(IX=10, IY=8, C=6, K=12, stride=2, depthwise=net == "dw_block")
    counters = {}
    cm = _lowered(graph, make_h100_target() if target == "h100" else target, counters)
    convs = [ls for ls in cm.segments if ls.route == "tiled_conv"]
    assert convs and all(ls.meta["kernel"] == "conv_requant" for ls in convs)
    assert all("kernel" not in ls.meta for ls in cm.segments if ls.route != "tiled_conv")
    assert all(ls.meta["block_oy"] >= 1 for ls in convs)
    if net == "MobileNet":
        assert len(convs) == 27
    assert counters == {"lower.conv.fused": len(convs), "lower.route.tiled_conv": len(convs)}
    params = init_graph_params(graph, seed=2)
    x = {k: np.random.default_rng(4).integers(-128, 128, s).astype(np.float32) for k, s in graph.inputs.items()}
    _check_bit_exact(cm, graph, params, x)


@pytest.mark.parametrize("why", ["folded_scale", "folded_addend", "no_elem_bytes", "depthwise_15x15"])
def test_conv_segments_outside_the_pattern_keep_the_banded_executor(why):
    """A requant with folded ``scale``/``addend`` attrs, a graph whose
    anchors declare no ``elem_bytes``, or a depthwise filter of more taps
    than the kernel stages: the conv segment keeps today's banded conv and
    its chain, under the same route and band height."""
    wide = why == "depthwise_15x15"
    base = conv_block_graph(IX=8, IY=8, C=4, K=8, FY=15 if wide else 3, FX=15 if wide else 3, depthwise=wide)
    attrs = {"folded_scale": {"scale": 1.0}, "folded_addend": {"addend": 0.0}, "no_elem_bytes": {"elem_bytes": None},
             "depthwise_15x15": {}}
    graph = _rebuilt(base, **attrs[why])
    counters = {}
    cm = _lowered(graph, "gap9", counters)
    (conv,) = [ls for ls in cm.segments if ls.route == "tiled_conv"]
    assert conv.meta["kernel"] == "banded"
    assert conv.meta["block_oy"] == _lowered(base, "gap9").segments[0].meta["block_oy"]
    assert counters == {"lower.conv.fused": 0, "lower.route.tiled_conv": 1}
    params = init_graph_params(graph, seed=1)
    x = {"x": np.random.default_rng(1).integers(-128, 128, (1, 8, 8, 4)).astype(np.float32)}
    before = conv_requant.launches
    _check_bit_exact(cm, graph, params, x)
    assert conv_requant.launches == before


def test_fused_conv_with_runtime_scale_evaluates_reference_chain():
    """Requant params carrying scale/addend (or a shift the kernel does not
    model) are outside the fused epilogue: the segment evaluates its banded
    executor and chain, still bit-exact with the JAX interpreter."""
    import repro.cnn

    cm = port_compiled("MobileNet", "gap9")
    assert all(ls.meta["kernel"] == "conv_requant" for ls in cm.segments if ls.route == "tiled_conv")
    params, x = io("MobileNet")
    for extra in ({"scale": np.float32(3.0), "addend": np.float32(5.0)}, {"shift": np.float32(2.5)}):
        p = {k: dict(v) for k, v in params.items()}
        for ls in cm.segments:
            if ls.route == "tiled_conv":
                rq = next(n for n in ls.segment.nodes if n.op == "requant")
                p[rq.name].update(extra)
        want = repro.cnn.execute_graph(cm.graph, p, x)
        got = cm.run(p, x)
        for k in want:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), extra


class _OpLog(torch.utils._python_dispatch.TorchDispatchMode):
    """Every aten op dispatched while the mode is on."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("net,tgt", [("MobileNet", "gap9"), ("DSCNN", "diana"), ("ResNet", "ne16_octa")])
def test_conv_route_issues_nothing_but_views_outside_the_kernel(monkeypatch, net, tgt, dtype):
    """With the kernel wrapper stubbed, a fused conv segment's executor
    issues no aten op but views: on the card the segment is the one
    launch.  An int8 graph input adds its one cast to float32."""
    cm = port_compiled(net, tgt)
    params = params_to_torch(io(net)[0], "cpu")
    calls = []

    def stub(x, w, bias=None, **kw):
        calls.append((x, w, bias, kw))
        return out

    monkeypatch.setattr(lower_mod, "conv_requant", stub)
    segments = [ls for ls in cm.segments if ls.meta.get("kernel") == "conv_requant"]
    assert segments
    for ls in segments:
        sp = ls.params_slice(params)
        a = ls.segment.anchor
        shape = (1, int(a.attr("OY")) * int(a.attr("stride", 1) or 1), int(a.attr("OX")) * int(a.attr("stride", 1) or 1),
                 int(a.attr("C")))
        x = torch.from_numpy(np.random.default_rng(1).integers(-128, 128, shape).astype(np.float32)).to(dtype)
        out = torch.zeros(1)
        calls.clear()
        with _OpLog() as log:
            got = ls.fn(sp, x)
        assert got is out
        casts = [torch.ops.aten._to_copy.default] if dtype != torch.float32 else []
        assert [op for op in log.ops if not op.is_view] == casts, log.ops
        (xa, wa, ba, kw), = calls
        assert xa.dtype == torch.float32 and tuple(xa.shape) == shape
        assert wa is sp[a.name]["w"]
        assert ba is None or any(ba is p.get("b") for p in sp.values())
        assert kw["block_oy"] == ls.meta["block_oy"]
        assert kw["depthwise"] == (a.op == "dwconv2d") and kw["relu"] == (ls.segment.nodes[-1].op == "relu")


@pytest.mark.parametrize("memory", [None, "xla", "arena"])
@pytest.mark.parametrize("net,tgt", [("MobileNet", "diana"), ("DSCNN", "gap9"), ("ResNet", "gap9")])
def test_conv_nets_through_lower_bit_exact_with_reference(net, tgt, memory):
    """``CompiledModel.run`` (``memory=None``) and the AOT executor in each
    memory mode, where a segment's input is an arena view."""
    cm = port_compiled(net, tgt)
    assert any(ls.meta.get("kernel") == "conv_requant" for ls in cm.segments)
    params, x = io(net)
    got = cm.run(params, x) if memory is None else compile_aot(cm, memory=memory).run(params, x)
    for k, want in ref_outputs(net).items():
        assert np.array_equal(got[k].numpy(), want), k
