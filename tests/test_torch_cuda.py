"""The port on the CUDA card: every kernel- and path-level correctness check.

The Hopper kernels against their plain versions: both GEMM entries bit-exact
on the CNN path's shapes, the test grid and ragged shapes (the segment entry
also on arena views, fractional inputs and a bias beyond 2^24; both branches,
each forced, across the rule's knee; one launch of one device kernel per GEMM
segment); the fused conv at every conv layer shape of MobileNetV1-0.25 and
DS-CNN's first; flash, ``moe_gmm``, ``ssd_scan`` and ``rglru_scan`` on their
test grids, ragged, strided and misaligned operands and the served models'
shapes (``moe_gmm`` also with routed rows).  The CNN paths: the four
MLPerf-Tiny nets on gap9, diana and h100 eagerly and by AOT replay in both
memory modes, bit-exact with exact launch counts; pipelined and streamed
runs; the 16-slot request server.  Small LMs through the kernels against the
CPU.  Marked ``cuda``; without a card each test skips (decided inside the
fixture, never at import).  ``chip_smoke.py`` times the kernels and runs the
full-width phases."""

import numpy as np
import pytest
import torch

from repro_torch import _graphs, obs
from repro_torch.backend import lower
from repro_torch.cnn import execute_graph, init_graph_params, mlperf_tiny_networks, params_to_torch
from repro_torch.core import dispatch
from repro_torch.configs import get_smoke
from repro_torch.kernels import (
    conv_requant,
    conv_requant_plain,
    flash_attention,
    flash_attention_plain,
    matmul_requant,
    matmul_requant_f32,
    matmul_requant_f32_plain,
    matmul_requant_plain,
    moe_gmm,
    moe_gmm_plain,
    rglru_scan,
    rglru_scan_plain,
    ssd_scan,
    ssd_scan_plain,
)
from repro_torch.kernels.ref import rglru_scan_ref, ssd_scan_ref
from repro_torch.models import LM
from repro_torch.models import moe as pmoe
from repro_torch.targets import make_h100_target

pytestmark = pytest.mark.cuda

# (K, N) of every dense on the CNN path: all run at M = 1, and DAE's at the
# rows of a served batch
MAIN_KN = [(640, 128), (128, 128), (128, 8), (8, 128), (128, 640), (64, 10), (256, 2), (64, 12)]
# both GEMM entries: the main path's shapes at M = 1, 2 and 16, the kernel
# test grid, and ragged M, N and K (heads of N = 2 and 10, K = 8 and 13, M
# one past a 16-row tile, K beyond one block's staged 1024 columns)
SHAPES = ([(m, k, n) for m in (1, 2, 16) for k, n in MAIN_KN]
          + [(8, 16, 128), (32, 64, 128), (128, 128, 256), (16, 96, 384), (3, 37, 11), (48, 80, 112)]
          + [(17, 13, 10), (2, 8, 2), (17, 640, 10), (1, 13, 640), (33, 200, 24), (5, 2100, 40), (16, 1030, 9)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _device_nodes(fn) -> list[str]:
    """The device work one call of ``fn`` enqueues, read through the driver
    from a CUDA graph that captures one call: each kernel node's function
    name (mangled), and ``"node type <t>"`` (``CUgraphNodeType``: 1 a copy,
    2 a fill, ...) for any other node.  A graph holds exactly what the call
    enqueues; a profiler session on the card now and then records none of
    it."""
    import ctypes

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                    ("shared_bytes", ctypes.c_uint), ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    driver = ctypes.CDLL("libcuda.so.1")
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    assert driver.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert driver.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    out = []
    for node in nodes:
        t = ctypes.c_int()
        assert driver.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) == 0
        if t.value != 0:
            out.append(f"node type {t.value}")
            continue
        p = KernelNodeParams()
        assert driver.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(p)) == 0
        func = ctypes.c_void_p(p.func)
        if not p.func:  # a node made from a library kernel names it by its CUkernel
            assert driver.cuKernelGetFunction(ctypes.byref(func), ctypes.c_void_p(p.kern)) == 0
        name = ctypes.c_char_p()
        assert driver.cuFuncGetName(ctypes.byref(name), func) == 0
        out.append(name.value.decode())
    return out


def _target(name: str):
    """A target by name; the card's own h100 built here (nothing registers it on import)."""
    return make_h100_target() if name == "h100" else name


@pytest.mark.parametrize("layout", ["contiguous", "column stride M"])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_kernel_matches_plain_version(cuda, M, K, N, transposed, layout):
    rng = np.random.default_rng(M * K + N)
    a = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)).to(cuda)
    if transposed:  # the (K, N) view of an (N, K) weight, as the lowering passes it
        w = torch.from_numpy(rng.integers(-128, 128, (N, K)).astype(np.int8)).to(cuda).T
    else:
        w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8)).to(cuda)
    mult = torch.from_numpy(rng.integers(1, 8, (N,)).astype(np.int32)).to(cuda)
    bias = torch.from_numpy(rng.integers(-1000, 1000, (N,)).astype(np.int32)).to(cuda)
    if layout == "column stride M":  # element-wise loads
        a = a.T.contiguous().T
    for rounding in ("floor", "even"):
        for relu in (False, True):
            for shift in (0, 5, 8, 13):
                before = matmul_requant.launches
                got = matmul_requant(a, w, mult, bias, shift=shift, relu=relu, rounding=rounding)
                torch.cuda.synchronize()
                assert matmul_requant.launches == before + 1
                want = matmul_requant_plain(a, w, mult, bias, shift=shift, relu=relu, rounding=rounding)
                assert torch.equal(got, want), (rounding, relu, shift)


def test_kernel_rejects_mixed_devices(cuda):
    a = torch.zeros((1, 8), dtype=torch.int8, device=cuda)
    w = torch.zeros((8, 4), dtype=torch.int8)
    ones = torch.ones(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        matmul_requant(a, w, ones, ones)


def test_dscnn_main_path_bit_exact_on_card(cuda):
    g = mlperf_tiny_networks()["DSCNN"]
    params = init_graph_params(g)
    x = {k: np.random.default_rng(0).integers(-128, 128, s).astype(np.float32) for k, s in g.inputs.items()}
    cm = lower(dispatch(g, "gap9", budget=300))
    assert cm.device.type == "cuda"
    before = matmul_requant.launches
    out = cm.run(params_to_torch(params, cuda), x)
    torch.cuda.synchronize()
    assert matmul_requant.launches - before == cm.routes()["pallas_gemm"]
    ref = execute_graph(g, params, x, device="cpu")
    for k in ref:
        assert out[k].device.type == "cuda"
        assert torch.equal(out[k].cpu(), ref[k])
    assert cm.verify(params, x, per_segment=True).exact


def _segment_operands(cuda, M, K, N, seed, fractional=False, big_bias=False):
    """Integer-valued float32 activations (M, K), the dense weight (N, K)
    and bias (N,) on the card, as the lowering holds them; ``big_bias``
    draws the bias beyond 2^24, where a float32 holds only even integers."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (M, K)).astype(np.float32)
    w = rng.integers(-128, 128, (N, K)).astype(np.float32)
    if fractional:  # inside int8 range: truncation toward zero must agree
        x = np.clip(x + rng.uniform(-0.99, 0.99, x.shape), -128.99, 127.99).astype(np.float32)
        w = np.clip(w + rng.uniform(-0.99, 0.99, w.shape), -128.99, 127.99).astype(np.float32)
    hi = 1 << 30 if big_bias else 1000
    b = rng.integers(-hi, hi, (N,)).astype(np.float32)
    return [torch.from_numpy(v).to(cuda) for v in (x, w, b)]


def _segment_equal(x, w, b, **kw):
    before = matmul_requant.launches
    got = matmul_requant_f32(x, w, b, **kw)
    torch.cuda.synchronize()
    assert matmul_requant.launches == before + 1
    want = matmul_requant_f32_plain(x, w, b, **kw)
    assert got.dtype == torch.float32 and torch.equal(got, want), kw


@pytest.mark.parametrize("variant", ["as drawn", "fractional", "bias beyond 2^24", "misaligned", "column stride M"])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_segment_entry_matches_plain_version(cuda, M, K, N, variant):
    """Bit-exact with the plain version as drawn, with fractional operands
    inside int8 range, a bias beyond 2^24, A one float off 16 bytes (an
    arena view) and A with column stride M; with and without the bias."""
    x, w, b = _segment_operands(cuda, M, K, N, seed=M * K + N, fractional=variant == "fractional",
                                big_bias=variant == "bias beyond 2^24")
    if variant == "misaligned":
        x = _off_by_one(x)
    if variant == "column stride M":
        x = x.T.contiguous().T
    for rounding in ("floor", "even"):
        for relu in (False, True):
            for bias in (b, None):
                for shift in (0, 5, 13):
                    _segment_equal(x, w, bias, shift=shift, relu=relu, rounding=rounding)
    with pytest.raises(TypeError):  # the lowering casts an int8 graph input to float32 first
        matmul_requant_f32(x.to(torch.int8), w, b)


def _both_branches_match(cuda, M, K, N, segment, seed):
    """Both branches of one entry, each forced, give the plain version's
    bits; the rule takes the GEMV up to 512 blocks of 8 outputs."""
    import importlib

    mr = importlib.import_module("repro_torch.kernels.matmul_requant")
    kw = dict(shift=5, relu=True, rounding="even")
    if segment:
        x, w, b = _segment_operands(cuda, M, K, N, seed=seed)
        want = matmul_requant_f32_plain(x, w, b, **kw)
        args, strides, dtype = (x, w, None, b), (w.stride(0), w.stride(1)), torch.float32
    else:
        rng = np.random.default_rng(seed)
        a, w = (torch.from_numpy(rng.integers(-128, 128, s).astype(np.int8)).to(cuda) for s in ((M, K), (N, K)))
        w = w.T  # the (K, N) view of an (N, K) weight
        mult = torch.from_numpy(rng.integers(1, 8, (N,)).astype(np.int32)).to(cuda)
        bias = torch.from_numpy(rng.integers(-1000, 1000, (N,)).astype(np.int32)).to(cuda)
        want = matmul_requant_plain(a, w, mult, bias, **kw)
        args, strides, dtype = (a, w, mult, bias), (w.stride(1), w.stride(0)), torch.int8
    for path in (mr.TENSOR_CORES, mr.GEMV):
        out = torch.empty((M, N), dtype=dtype, device=cuda)
        mr._launch(*args, out, *strides, 5, "even", True, segment=segment, path=path)
        torch.cuda.synchronize()
        assert torch.equal(out, want), path
    assert mr.launch_shape(M, N, K)[2] == (mr.GEMV if M * -(-N // 8) <= 512 else mr.TENSOR_CORES)


@pytest.mark.parametrize("segment", [False, True])
@pytest.mark.parametrize("M,K,N", [(1, k, n) for k, n in MAIN_KN] + [(1, 8, 128), (1, 13, 10), (1, 2100, 40),
                                                                      (1, 128, 4096), (1, 128, 8192)])
def test_both_branches_match_plain_version_at_one_row(cuda, M, K, N, segment):
    """At one row, as the CNN path calls every dense, the rule takes the
    GEMV up to N = 4096; the branch it leaves, forced, must give the same
    bits (chip_smoke.py's sweep times both)."""
    _both_branches_match(cuda, M, K, N, segment, seed=3)


@pytest.mark.parametrize("segment", [False, True])
@pytest.mark.parametrize("M,K,N", [(16, k, n) for k, n in MAIN_KN[:5]] + [
    (17, 13, 10), (40, 1030, 9), (16, 128, 4096), (16, 128, 256), (16, 128, 384), (16, 128, 512), (32, 128, 128),
    (64, 128, 128)])
def test_both_branches_match_plain_version_at_many_rows(cuda, M, K, N, segment):
    """At DAE's served rows, ragged row counts and on either side of the
    rule's knee."""
    _both_branches_match(cuda, M, K, N, segment, seed=6)


@pytest.mark.parametrize("M,K,N", [(1, 640, 128), (16, 640, 128), (16, 8, 128), (17, 13, 10)])
def test_segment_entry_takes_a_four_byte_aligned_arena_view(cuda, M, K, N):
    """In memory="arena" an activation is a float32 view at a planned
    offset: A may be 4-byte aligned only (and any view may be strided)."""
    x, w, b = _segment_operands(cuda, M, K, N, seed=1)
    arena = torch.zeros(1 + M * K, dtype=torch.float32, device=cuda)
    view = arena[1:].view(M, K)
    view.copy_(x)
    assert view.data_ptr() % 16 == 4
    for rounding in ("floor", "even"):
        _segment_equal(view, w, b, shift=5, relu=False, rounding=rounding)
    _segment_equal(x.T.contiguous().T, w, b, shift=5, relu=True, rounding="even")  # column stride M


@pytest.mark.parametrize("M,K,N", [(1, 640, 128), (16, 128, 640), (17, 13, 10)])
def test_segment_entry_truncates_non_integer_inputs_as_the_cast_does(cuda, M, K, N):
    x, w, b = _segment_operands(cuda, M, K, N, seed=2, fractional=True)
    assert not torch.equal(x, x.trunc())
    for rounding in ("floor", "even"):
        _segment_equal(x, w, b, shift=5, relu=False, rounding=rounding)


@pytest.mark.parametrize("tgt", ["gap9", "h100"])
@pytest.mark.parametrize("M", [1, 16])
def test_gemm_segment_is_one_launch_of_one_device_kernel(cuda, M, tgt):
    """Every DAE GEMM segment on the card: one counted launch, and a graph
    of one call holds one node, the GEMM's kernel: no cast and no fill."""
    g = mlperf_tiny_networks()["DAE"]
    cm = lower(dispatch(g, _target(tgt), budget=300))
    dev_params = params_to_torch(init_graph_params(g), cuda)
    segments = [ls for ls in cm.segments if ls.route == "pallas_gemm"]
    assert len(segments) == 10
    for ls in segments:
        sp = ls.params_slice(dev_params)
        k = sp[ls.segment.anchor.name]["w"].shape[1]
        x = torch.from_numpy(np.random.default_rng(k).integers(-128, 128, (M, k)).astype(np.float32)).to(cuda)
        before = matmul_requant.launches
        ls.fn(sp, x)
        torch.cuda.synchronize()
        assert matmul_requant.launches == before + 1
        # the call's only device work: that one launch, no cast and no fill
        nodes = _device_nodes(lambda: ls.fn(sp, x))  # noqa: B023 (called before the loop moves on)
        assert len(nodes) == 1 and "matmul_requant" in nodes[0], nodes


def _cnn_launches(cm, runs: int) -> dict[str, int]:
    """The launches of ``runs`` runs of a CNN: one GEMM per GEMM segment, one
    fused conv per fused conv segment, and nothing else."""
    convs = sum(ls.meta.get("kernel") == "conv_requant" for ls in cm.segments)
    return {**dict.fromkeys(_graphs.launch_counts(), 0), "matmul_requant": cm.routes().get("pallas_gemm", 0) * runs,
            "conv_requant": convs * runs}


def _launched_since(before: dict[str, int]) -> dict[str, int]:
    return {k: v - before[k] for k, v in _graphs.launch_counts().items()}


@pytest.mark.parametrize("memory", ["xla", "arena"])
@pytest.mark.parametrize("tgt", ["gap9", "diana", "h100"])
@pytest.mark.parametrize("net", ["DAE", "DSCNN", "ResNet", "MobileNet"])
def test_dae_aot_replay_bit_exact_with_exact_launches(cuda, net, tgt, memory):
    """Each net on each target, eagerly (``CompiledModel.run``) and by AOT
    replay: bit-exact with the CPU interpreter, a rerun of the first request
    too (the arena reused), and one GEMM launch per GEMM segment and one
    fused conv launch per fused conv segment a request, nothing else."""
    from repro_torch.backend import compile_aot

    g = mlperf_tiny_networks()[net]
    params = init_graph_params(g)
    rng = np.random.default_rng(4)
    xs = [{k: rng.integers(-128, 128, s).astype(np.float32) for k, s in g.inputs.items()} for _ in range(3)]
    cpu_params = params_to_torch(params, "cpu")
    refs = [execute_graph(g, cpu_params, x, device="cpu") for x in xs]
    cm = lower(dispatch(g, _target(tgt), budget=300))
    dev_params = params_to_torch(params, cuda)
    before = _graphs.launch_counts()
    eager = [cm.run(dev_params, x) for x in xs]
    torch.cuda.synchronize()
    assert _launched_since(before) == _cnn_launches(cm, len(xs))
    am = compile_aot(cm, memory=memory)
    am.warmup(params, xs[0])
    before = _graphs.launch_counts()
    outs = [am.run(params, x) for x in xs]
    torch.cuda.synchronize()
    assert _launched_since(before) == _cnn_launches(cm, len(xs))
    outs.append(am.run(params, xs[0]))
    for out, e, ref in zip(outs, eager + eager[:1], refs + refs[:1]):
        for k in ref:
            assert out[k].device.type == "cuda"
            assert torch.equal(e[k].cpu(), ref[k]), ("eager", k)
            assert torch.equal(out[k].cpu(), ref[k]), ("aot", k)


# the fused conv (conv_requant): every distinct conv layer of MobileNetV1-0.25
# (IY, IX, C, K, FY, FX, stride, depthwise) and DS-CNN's 10x4 stride-2 first layer
CONV_SHAPES = [(96, 96, 3, 8, 3, 3, 2, False)] + [
    shape
    for c, k, hw, st in ((8, 16, 48, 1), (16, 32, 48, 2), (32, 32, 24, 1), (32, 64, 24, 2), (64, 64, 12, 1),
                         (64, 128, 12, 2), (128, 128, 6, 1), (128, 256, 6, 2), (256, 256, 3, 1))
    for shape in ((hw, hw, c, c, 3, 3, st, True), (hw // st, hw // st, c, k, 1, 1, 1, False))
] + [(49, 10, 1, 64, 10, 4, 2, False)]


def _conv_equal(x, w, b, **kw):
    before = conv_requant.launches
    got = conv_requant(x, w, b, **kw)
    torch.cuda.synchronize()
    assert conv_requant.launches == before + 1
    want = conv_requant_plain(x, w, b, **kw)
    assert got.dtype == torch.float32 and torch.equal(got, want), kw


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_requant_matches_plain_version(cuda, shape, batch):
    iy, ix, c, k, fy, fx, stride, dw = shape
    rng = np.random.default_rng(sum(shape[:6]) + batch)
    x = torch.from_numpy(rng.integers(-128, 128, (batch, iy, ix, c)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.integers(-128, 128, (fy, fx, 1, c) if dw else (fy, fx, c, k)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.integers(-3000, 3000, (w.shape[3],)).astype(np.float32)).to(cuda)
    oy = -(-iy // stride)
    for block_oy in (0, 1, 3, oy):
        for relu in (False, True):
            _conv_equal(x, w, b, stride=stride, depthwise=dw, shift=5, relu=relu, block_oy=block_oy)
    for shift in (0, 1, 12):  # no shift (clips at both ends), ties at every odd sum, large sums
        _conv_equal(x, w, b, stride=stride, depthwise=dw, shift=shift)
    _conv_equal(x, w, None, stride=stride, depthwise=dw, shift=7, relu=True)
    # NHWC with W outermost in memory, as a strided view
    view = x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    _conv_equal(view, w, b, stride=stride, depthwise=dw, shift=5, relu=True)


def test_conv_requant_fractions_and_chunked_channels(cuda):
    """Fractional operands inside int8 range truncate toward zero as the
    plain version's casts do; a dense conv whose weights exceed the
    kernel's shared memory is staged in chunks of input channels."""
    rng = np.random.default_rng(9)
    for (iy, c, k, f) in ((12, 40, 24, 3), (5, 700, 40, 3)):
        x = np.clip(rng.integers(-128, 128, (2, iy, iy, c)) + rng.uniform(-0.99, 0.99, (2, iy, iy, c)), -128.99, 127.99)
        w = np.clip(rng.integers(-128, 128, (f, f, c, k)) + rng.uniform(-0.99, 0.99, (f, f, c, k)), -128.99, 127.99)
        b = rng.integers(-3000, 3000, (k,))
        xt, wt, bt = (torch.from_numpy(v.astype(np.float32)).to(cuda) for v in (x, w, b))
        _conv_equal(xt, wt, bt, stride=1, shift=9, relu=True)
        _conv_equal(xt, wt, bt, stride=2, shift=9, block_oy=2)


@pytest.mark.parametrize("C,K,depthwise", [(5, 6, False), (8, 12, False), (6, 6, True), (8, 8, True), (3, 2, False)])
def test_conv_requant_ragged_channels_and_misaligned_input(cuda, C, K, depthwise):
    """Channel counts that are no multiple of four take the kernel's
    element-wise loads; so does an input one float off 16 bytes, as an
    arena view may be."""
    rng = np.random.default_rng(C * K)
    n = 2 * 9 * 7 * C
    flat = torch.from_numpy(rng.integers(-128, 128, (n + 1,)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.integers(-128, 128, (3, 3, 1, C) if depthwise else (3, 3, C, K)).astype(np.float32))
    w = w.to(cuda)
    b = torch.from_numpy(rng.integers(-3000, 3000, (w.shape[3],)).astype(np.float32)).to(cuda)
    for x in (flat[:n].view(2, 9, 7, C), flat[1:].view(2, 9, 7, C)):
        for stride in (1, 2):
            _conv_equal(x, w, b, stride=stride, depthwise=depthwise, shift=6, relu=True)
            _conv_equal(x, w, b, stride=stride, depthwise=depthwise, shift=3, block_oy=2)


@pytest.mark.parametrize("net", ["MobileNet", "DSCNN"])
def test_conv_segments_launch_once_each_on_h100(cuda, net):
    """On the card's own target every conv segment of the net is one
    launch of the fused conv, eagerly and under AOT replay, bit-exact
    with the CPU interpreter."""
    from repro_torch.backend import compile_aot
    from repro_torch.targets import make_h100_target

    g = mlperf_tiny_networks()[net]
    params = init_graph_params(g)
    x = {k: np.random.default_rng(2).integers(-128, 128, s).astype(np.float32) for k, s in g.inputs.items()}
    ref = execute_graph(g, params, x, device="cpu")
    cm = lower(dispatch(g, make_h100_target(), budget=300))
    fused = [ls for ls in cm.segments if ls.meta.get("kernel") == "conv_requant"]
    assert fused and len(fused) == cm.routes()["tiled_conv"]
    dev_params = params_to_torch(params, cuda)
    before = conv_requant.launches
    out = cm.run(dev_params, x)
    torch.cuda.synchronize()
    assert conv_requant.launches - before == len(fused)
    for k in ref:
        assert torch.equal(out[k].cpu(), ref[k])
    # one device kernel per fused segment call, and nothing else (the
    # first segment reads the graph's input)
    ls = fused[0]
    assert ls.input_names == ("x",)
    sp = ls.params_slice(dev_params)
    xin = torch.from_numpy(x["x"]).to(cuda)
    before = conv_requant.launches
    ls.fn(sp, xin)
    torch.cuda.synchronize()
    assert conv_requant.launches == before + 1
    nodes = _device_nodes(lambda: ls.fn(sp, xin))
    assert len(nodes) == 1 and "conv_requant" in nodes[0], nodes
    am = compile_aot(cm)
    am.warmup(params, x)
    before = conv_requant.launches
    outs = [am.run(params, x) for _ in range(3)]
    torch.cuda.synchronize()
    assert conv_requant.launches - before == 3 * len(fused)
    for o in outs:
        for k in ref:
            assert torch.equal(o[k].cpu(), ref[k])


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the kernel test grid, ragged lengths, and qwen2.5-3b's heads at the serving
# engine's prompt lengths and past them
FLASH_GRID = [(1, 4, 4, 64, 64, 32), (2, 8, 2, 128, 128, 64), (1, 6, 1, 96, 96, 16), (4, 16, 2, 24, 24, 128),
              (1, 4, 2, 37, 37, 256), (2, 4, 1, 5, 5, 24), (2, 4, 1, 24, 24, 24), (2, 4, 1, 37, 37, 24),
              (4, 16, 2, 4, 4, 128), (4, 16, 2, 17, 17, 128), (4, 16, 2, 35, 35, 128)]


def _qkv(cuda, B, H, KV, Sq, Sk, D, dtype, seed, bshd=False):
    rng = np.random.default_rng(seed)
    if bshd:  # (B, S, H, D) storage handed over as (B, H, S, D) views
        mk = lambda s: torch.from_numpy(rng.normal(size=(s[0], s[2], s[1], s[3])).astype(np.float32)).transpose(1, 2)
    else:
        mk = lambda s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return [mk(s).to(cuda, dtype) for s in ((B, H, Sq, D), (B, KV, Sk, D), (B, KV, Sk, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,D", FLASH_GRID)
def test_flash_kernel_matches_plain_version(cuda, B, H, KV, Sq, Sk, D, causal, dtype):
    # a model's heads (D >= 128) as the model lays them out
    q, k, v = _qkv(cuda, B, H, KV, Sq, Sk, D, dtype, seed=Sq * D, bshd=D >= 128)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.stride() == q.stride()
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,KV,Sq,Sk,D,q_offset,causal,window",
    [(2, 4, 2, 16, 64, 32, 48, True, None), (2, 4, 2, 64, 64, 32, 0, True, 16), (2, 4, 2, 32, 64, 32, 32, True, 8),
     (2, 4, 2, 64, 64, 32, 0, False, 24), (2, 4, 2, 8, 32, 32, 100, True, 4), (2, 4, 2, 1, 200, 32, 199, True, None),
     (2, 4, 2, 40, 300, 32, 260, True, 70), (2, 4, 2, 1, 40, 32, 39, True, None),
     (2, 4, 2, 24, 300, 32, 276, True, None)]
    # recurrentgemma-2b's local attention (window 2048) at the serving
    # engine's prompt lengths, and its heads with a window that bites
    + [(4, 10, 1, S, S, 256, 0, True, 2048) for S in (4, 17, 24, 35)] + [(1, 10, 1, 300, 300, 256, 0, True, 64)],
)
def test_flash_kernel_offset_and_window(cuda, B, H, KV, Sq, Sk, D, q_offset, causal, window, dtype):
    q, k, v = _qkv(cuda, B, H, KV, Sq, Sk, D, dtype, seed=Sq + Sk, bshd=D >= 128)
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])


def _off_by_one(x):
    """A contiguous copy of ``x`` starting one element past an allocation:
    every row one element off 16 bytes, so bf16 is staged by element loads."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(sq, sk) for sq in (1, 63, 65, 129) for sk in (1, 63, 65, 129)])
@pytest.mark.parametrize("D", [24, 80, 256])
def test_flash_bf16_ragged_head_dims_and_lengths(cuda, D, Sq, Sk, causal):
    """The tensor-core path zero-fills D to a multiple of 16 and masks
    ragged Sq, Sk; causal is end-aligned (q_offset = Sk - Sq, so Sq > Sk
    leaves rows with no valid key)."""
    q, k, v = _qkv(cuda, 1, 4, 2, Sq, Sk, D, torch.bfloat16, seed=D + Sq * Sk)
    kw = {"causal": causal, "q_offset": Sk - Sq if causal else 0}
    got = flash_attention(q, k, v, **kw)
    torch.testing.assert_close(got.float(), flash_attention_plain(q, k, v, **kw).float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [24, 128, 256])
def test_flash_kernel_takes_misaligned_rows(cuda, D, dtype, causal):
    q, k, v = (_off_by_one(t) for t in _qkv(cuda, 2, 4, 2, 70, 70, D, dtype, seed=D))
    assert q.data_ptr() % 16 != 0
    got = flash_attention(q, k, v, causal=causal)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), flash_attention_plain(q, k, v, causal=causal).float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,q_offset", [(64, 64, -10), (100, 80, -30), (5, 130, -7)])
def test_flash_kernel_rows_with_no_valid_key(cuda, Sq, Sk, q_offset, dtype):
    """Rows at negative positions under the causal mask score -1e30
    everywhere and average v over all Sk keys, as both references do."""
    q, k, v = _qkv(cuda, 2, 4, 2, Sq, Sk, 64, dtype, seed=Sq - q_offset)
    got = flash_attention(q, k, v, causal=True, q_offset=q_offset)
    want = flash_attention_plain(q, k, v, causal=True, q_offset=q_offset)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    n_dead = min(Sq, -q_offset)
    mean_v = v.float().mean(dim=2, keepdim=True).repeat_interleave(2, dim=1)
    torch.testing.assert_close(got[:, :, :n_dead].float(), mean_v.expand(-1, -1, n_dead, -1), atol=tol, rtol=tol)


def test_flash_kernel_rejects_mixed_dtypes_and_devices(cuda):
    q = torch.zeros((1, 2, 4, 16), device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        flash_attention(q, q.cpu(), q)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "gemma_7b"])
def test_two_layer_lm_prefill_launches_flash_per_layer(cuda, arch):
    cfg = get_smoke(arch).replace(n_layers=2, dtype="float32")
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (3, 9)))
    before = flash_attention.launches
    with torch.inference_mode():
        lg, cache = gpu.prefill(toks.to(cuda), max_len=16)
        assert flash_attention.launches - before == cfg.n_layers
        want, want_cache = cpu.prefill(toks, max_len=16)
        torch.testing.assert_close(lg.cpu(), want, atol=1e-3, rtol=1e-3)
        for t in range(3):
            nxt = want.argmax(-1)
            assert torch.equal(lg.argmax(-1).cpu(), nxt)
            lg, cache = gpu.decode_step(cache, nxt.to(cuda), 9 + t)
            want, want_cache = cpu.decode_step(want_cache, nxt, 9 + t)
            torch.testing.assert_close(lg.cpu(), want, atol=1e-3, rtol=1e-3)
    assert flash_attention.launches - before == cfg.n_layers  # decode attention is plain torch


# the kernel test grid, ragged shapes, granite-moe-3b-a800m's wi and wo at the
# serving engine's 4 slots x capacity 8, a refill's 16 and one slot's decode,
# and granite-4.0-h-small's at a decode's 8 slots and a prefill's 256 and 512
GMM_SHAPES = [(2, 16, 32, 64), (8, 64, 128, 128), (3, 8, 16, 384), (3, 37, 45, 70), (5, 1, 7, 3), (2, 33, 100, 65),
              (3, 37, 64, 72)] + [
    (E, C, *dims) for E, Cs, D, F in ((40, (32, 16, 8), 1536, 512), (72, (8, 256, 512), 4096, 768))
    for C in Cs for dims in ((D, F), (F, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F", GMM_SHAPES)
def test_moe_gmm_kernel_matches_plain_version(cuda, E, C, D, F, dtype):
    rng = np.random.default_rng(E * C + F)
    x = torch.from_numpy(rng.normal(size=(E, C, D)).astype(np.float32)).to(cuda, dtype)
    w = torch.from_numpy((rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)).to(cuda, dtype)
    before = moe_gmm.launches
    got = moe_gmm(x, w)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 1
    assert got.dtype == dtype and got.shape == (E, C, F)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), moe_gmm_plain(x, w).float(), atol=tol, rtol=tol)
    # x as the (E, C, D) view of (C, E, D) storage; x and w one element off 16 bytes
    xt = x.transpose(0, 1).contiguous().transpose(0, 1)
    torch.testing.assert_close(moe_gmm(xt, w).float(), moe_gmm_plain(x, w).float(), atol=tol, rtol=tol)
    torch.testing.assert_close(moe_gmm(_off_by_one(x), _off_by_one(w)).float(), moe_gmm_plain(x, w).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("layout", ["misaligned", "strided"])
@pytest.mark.parametrize("E,C,D,F", [(40, 8, 1536, 512), (40, 8, 512, 1536), (40, 32, 1536, 512), (3, 37, 64, 72),
                                     (2, 33, 100, 65)])
def test_moe_gmm_bf16_decode_slot_and_layouts(cuda, E, C, D, F, layout):
    """granite's one-slot decode (C = 8) and its serving shapes, with x
    and w one element off 16 bytes (element loads) or x as the (E, C, D)
    view of (C, E, D) storage (16-byte copies through the strides)."""
    rng = np.random.default_rng(E * C + D)
    x = torch.from_numpy(rng.normal(size=(E, C, D)).astype(np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)).to(cuda, torch.bfloat16)
    if layout == "misaligned":
        x, w = _off_by_one(x), _off_by_one(w)
    else:
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    got = moe_gmm(x, w)
    torch.testing.assert_close(got.float(), moe_gmm_plain(x, w).float(), atol=2e-2, rtol=2e-2)


def _granite_decode_rows(B, E, filled, seed):
    """(B, E) int32: ``filled`` experts of each batch row hold one pair."""
    g = torch.Generator().manual_seed(seed)
    return torch.stack([(torch.randperm(E, generator=g) < filled).int() for _ in range(B)])


def _granite_prefill_rows(cap, seed):
    """(1, 72) int32: a prefill's ragged pairs an expert, cap / 4 to 3 cap / 4,
    one expert in ten empty."""
    counts = torch.randint(cap // 4, 3 * cap // 4 + 1, (1, 72), generator=torch.Generator().manual_seed(seed),
                           dtype=torch.int32)
    return counts * (torch.arange(72) % 10 != 0)


# (label, E, B, cap, D, F, rows): granite's decode (10 of 72 experts, wi and
# wo), B = 4 decode rows, ragged prefills of 256 and 512 slots an expert
# (some experts empty), and a misaligned F in f32
ROUTED_CASES = [
    ("decode wi", 72, 1, 8, 4096, 768, lambda: _granite_decode_rows(1, 72, 10, 0)),
    ("decode wo", 72, 1, 8, 768, 4096, lambda: _granite_decode_rows(1, 72, 10, 1)),
    ("decode B=4", 72, 4, 8, 4096, 768, lambda: _granite_decode_rows(4, 72, 10, 2)),
    ("prefill 256", 72, 1, 256, 4096, 768,
     lambda: torch.randint(60, 257, (1, 72), generator=torch.Generator().manual_seed(3), dtype=torch.int32)
     * (torch.arange(72) % 9 != 0)),
    ("prefill 256 wo", 72, 1, 256, 768, 4096, lambda: _granite_prefill_rows(256, 5)),
    ("prefill 512 wi", 72, 1, 512, 4096, 768, lambda: _granite_prefill_rows(512, 6)),
    ("prefill 512 wo", 72, 1, 512, 768, 4096, lambda: _granite_prefill_rows(512, 7)),
    ("prefill B=4", 6, 4, 40, 96, 70, lambda: torch.randint(0, 41, (4, 6), generator=torch.Generator().manual_seed(4),
                                                           dtype=torch.int32)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("label,E,B,cap,D,F,draw", ROUTED_CASES)
def test_moe_gmm_with_rows_matches_the_kernel_without_them(cuda, label, E, B, cap, D, F, draw, dtype):
    """Within the kernel's tolerance of the plain product with the same
    rows; bit for bit against the kernel without rows on the rows that
    hold a pair, 0 on the rest; and the tally the plain version's count of
    the rows of the tiles that run."""
    rng = np.random.default_rng(E * cap + F)
    rows = draw().to(cuda, torch.int32)
    x = torch.from_numpy(rng.normal(size=(E, B * cap, D)).astype(np.float32)).to(cuda, dtype)
    w = torch.from_numpy((rng.normal(size=(E, D, F)) / np.sqrt(D)).astype(np.float32)).to(cuda, dtype)
    tally, want_tally = (torch.zeros((), dtype=torch.int64, device=cuda) for _ in range(2))
    before = moe_gmm.launches
    got = moe_gmm(x, w, rows, tally=tally)
    full = moe_gmm(x, w)
    torch.cuda.synchronize()
    assert moe_gmm.launches == before + 2
    want = moe_gmm_plain(x, w, rows, tally=want_tally)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol, msg=label)
    filled = moe_gmm_plain(torch.ones_like(x[..., :1]), torch.ones_like(w[:, :1, :1]), rows) != 0
    filled = filled.expand_as(got)
    assert torch.equal(got[filled], full[filled]), label
    assert not got[~filled].any(), label
    assert int(tally) == int(want_tally), label


def _moe_layer(cuda, dtype):
    """granite-4.0-h's smoke MoE layer (dropless, a shared expert) on the card."""
    cfg = get_smoke("granite_4_0_h_small").replace(dtype=dtype)
    g = torch.Generator().manual_seed(0)

    def draw(specs):
        return {k: draw(v) if isinstance(v, dict) else
                (torch.randn(v.shape, generator=g) / v.shape[0] ** 0.5).to(cuda, getattr(torch, v.dtype))
                for k, v in specs.items()}

    return cfg, draw(pmoe.moe_params(cfg))


COUNTERS = ("moe.routed_pairs", "moe.rows_computed", "moe.dropped")


def _moved(before):
    after = obs.metrics_dict()["counters"]
    return {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_captured_moe_decode_reads_each_replays_routing(cuda, dtype):
    """One graph of a B = 2 decode layer, replayed on two inputs that route
    to different experts: each replay gives what the layer gives eagerly,
    bit for bit, and the moe counters move as eagerly."""
    cfg, params = _moe_layer(cuda, dtype)
    g = torch.Generator().manual_seed(1)
    inputs = [torch.randn((2, 1, cfg.d_model), generator=g).to(cuda, getattr(torch, dtype)) for _ in range(2)]
    with torch.inference_mode():
        routes = [pmoe._route(torch.softmax(x.float() @ params["router"], -1), cfg.top_k, 8)[2] for x in inputs]
        assert not torch.equal(routes[0], routes[1])
        want, eager = [], []
        for x in inputs:
            before = obs.metrics_dict()["counters"]
            want.append(pmoe.moe_ffn(params, x, cfg)[0])
            eager.append(_moved(before))
        static = inputs[0].clone()
        before = obs.metrics_dict()["counters"]
        graph = _graphs.capture(lambda: pmoe.moe_ffn(params, static, cfg)[0], cuda)
        assert _moved(before) == dict.fromkeys(COUNTERS, 0)  # warm-up and capture uncounted
        for i in (1, 0, 1):
            static.copy_(inputs[i])
            before = obs.metrics_dict()["counters"]
            out = graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, want[i]), i
            assert _moved(before) == eager[i], i
    assert eager[0]["moe.rows_computed"] > 0 and eager[0]["moe.routed_pairs"] == 2 * cfg.top_k


# (B, H, T, P, N, decay): the kernel test grid, ragged shapes, rows the
# kernels cannot read as vectors (P = 6, N = 10), and mamba2-1.3b's: the
# serving prefills (one chunk), then many 64-row chunks at full width with a
# ragged last one; at decay 0.2 a chunk decays by about e^-10, at 0.002 by
# about e^-0.1 and every chunk's output leans on the carried state
SSD_SHAPES = [(1, 2, 32, 8, 16, 0.2), (2, 4, 64, 16, 32, 0.2), (1, 3, 37, 8, 16, 0.2), (2, 2, 5, 16, 16, 0.2),
              (1, 2, 100, 16, 32, 0.2), (4, 64, 4, 64, 128, 0.2), (4, 64, 24, 64, 128, 0.2), (4, 64, 35, 64, 128, 0.2),
              (1, 64, 200, 64, 128, 0.2), (2, 3, 150, 6, 10, 0.2), (1, 64, 4096, 64, 128, 0.2),
              (4, 64, 512, 64, 128, 0.2), (1, 64, 4095, 64, 128, 0.2), (1, 64, 4096, 64, 128, 0.002),
              (1, 3, 200, 72, 20, 0.002)]


def _ssd_operands(cuda, B, H, T, P, N, bc_dtype, seed, decay=0.2):
    rng = np.random.default_rng(seed)
    # (B, T, H, P) storage handed over as (B, H, T, P) views, as the model does
    xb = torch.from_numpy(rng.normal(size=(B, T, H, P)).astype(np.float32)).to(cuda).transpose(1, 2)
    a = torch.from_numpy((-np.abs(rng.normal(size=(B, T, H))) * decay).astype(np.float32)).to(cuda).transpose(1, 2)
    Bm, Cm = (torch.from_numpy((rng.normal(size=(B, T, N)) / np.sqrt(N)).astype(np.float32)).to(cuda, bc_dtype)
              for _ in range(2))
    return xb, a, Bm, Cm


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,P,N,decay", SSD_SHAPES)
def test_ssd_scan_kernel_matches_plain_version(cuda, B, H, T, P, N, decay, bc_dtype):
    xb, a, Bm, Cm = _ssd_operands(cuda, B, H, T, P, N, bc_dtype, seed=T * P + N, decay=decay)
    before = ssd_scan.launches
    y, h = ssd_scan(xb, a, Bm, Cm)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.stride() == xb.stride()
    y_want, h_want = ssd_scan_plain(xb, a, Bm, Cm)
    torch.testing.assert_close(y, y_want, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(h, h_want, atol=2e-4, rtol=2e-4)
    if T <= 64:
        torch.testing.assert_close(y, ssd_scan_ref(xb, a, Bm, Cm), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("layout", ["strided B/C", "misaligned xb", "slow decay"])
def test_ssd_scan_kernel_many_chunks_layouts_and_carry(cuda, layout):
    """Over eight chunks: B and C read at stride 2, xb one element off 16
    bytes (both by element loads), and decays of about e^-0.1 a chunk, where
    every chunk's output leans on the carried state."""
    B, H, T, P, N = 2, 4, 512, 16, 32
    xb, a, Bm, Cm = _ssd_operands(cuda, B, H, T, P, N, torch.bfloat16, seed=5,
                                  decay=0.002 if layout == "slow decay" else 0.2)
    if layout == "strided B/C":
        Bm, Cm = (torch.stack([m, torch.zeros_like(m)], dim=-1).flatten(-2)[..., ::2] for m in (Bm, Cm))
        assert Bm.stride(-1) == 2
    if layout == "misaligned xb":
        buf = torch.empty(xb.numel() + 1, device=cuda)
        xb = buf[1:].view(B, H, T, P).copy_(xb)
    y, h = ssd_scan(xb, a, Bm, Cm)
    y_want, h_want = ssd_scan_plain(xb, a, Bm, Cm)
    torch.testing.assert_close(y, y_want, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(h, h_want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "mamba2_1_3b"])
def test_two_layer_moe_and_ssd_lm_on_card(cuda, arch):
    """prefill and 3 greedy decode steps on the card against the CPU, with
    the kernels' launch counts: 3 moe_gmm per MoE layer per call, one
    ssd_scan per ssd layer per prefill."""
    cfg = get_smoke(arch).replace(n_layers=2, dtype="float32")
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (3, 9)))
    before = (moe_gmm.launches, ssd_scan.launches)
    with torch.inference_mode():
        lg, cache = gpu.prefill(toks.to(cuda), max_len=16)
        want, want_cache = cpu.prefill(toks, max_len=16)
        torch.testing.assert_close(lg.cpu(), want, atol=1e-3, rtol=1e-3)
        for t in range(3):
            nxt = want.argmax(-1)
            assert torch.equal(lg.argmax(-1).cpu(), nxt)
            lg, cache = gpu.decode_step(cache, nxt.to(cuda), 9 + t)
            want, want_cache = cpu.decode_step(want_cache, nxt, 9 + t)
            torch.testing.assert_close(lg.cpu(), want, atol=1e-3, rtol=1e-3)
    calls = 4 if cfg.is_moe else 1
    assert (moe_gmm.launches - before[0], ssd_scan.launches - before[1]) == (
        3 * cfg.n_layers * calls if cfg.is_moe else 0,
        0 if cfg.is_moe else cfg.n_layers,
    )


# the kernel test grid, ragged shapes, and recurrentgemma-2b's W = 2560: the
# serving prefill, both sides of the one-chunk edge (64 steps: no chunk
# pairs, one kernel; 65: two chunks, two kernels), and long prefills
RGLRU_SHAPES = [(1, 32, 16), (2, 128, 64), (3, 64, 256), (2, 37, 45), (1, 5, 3), (3, 20, 130), (4, 4, 2560),
                (4, 24, 2560), (4, 35, 2560), (1, 300, 2560), (4, 64, 2560), (4, 65, 2560), (1, 4096, 2560),
                (1, 4097, 2560)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,W", RGLRU_SHAPES)
def test_rglru_scan_kernel_matches_plain_version(cuda, B, T, W, dtype):
    """Within the reference kernel test's 1e-4 of the plain version and the
    sequential oracle, also on (B, T, W) views of (T, B, W) storage."""
    rng = np.random.default_rng(B * T + W)
    a = torch.from_numpy(rng.uniform(0.2, 0.999, (B, T, W)).astype(np.float32)).to(cuda, dtype)
    b = torch.from_numpy(rng.normal(size=(B, T, W)).astype(np.float32)).to(cuda, dtype)
    before = rglru_scan.launches
    h = rglru_scan(a, b)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    assert h.dtype == torch.float32 and h.shape == (B, T, W) and h.is_contiguous()
    want = rglru_scan_plain(a, b)
    torch.testing.assert_close(h, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, rglru_scan_ref(a, b), atol=1e-4, rtol=1e-4)
    at, bt = (x.transpose(0, 1).contiguous().transpose(0, 1) for x in (a, b))
    torch.testing.assert_close(rglru_scan(at, bt), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [129, 4096])
def test_rglru_scan_split_path_carries_slow_decays(cuda, T, dtype):
    """Decays in U(0.99, 0.999): a 64-step chunk keeps about 0.6 of the
    state entering it, so every chunk's output leans on the folded carry;
    also on (B, T, W) views of (T, B, W) storage."""
    rng = np.random.default_rng(T)
    a = torch.from_numpy(rng.uniform(0.99, 0.999, (2, T, 2560)).astype(np.float32)).to(cuda, dtype)
    b = torch.from_numpy(rng.normal(size=(2, T, 2560)).astype(np.float32)).to(cuda, dtype)
    h = rglru_scan(a, b)
    want = rglru_scan_plain(a, b)
    torch.testing.assert_close(h, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h, rglru_scan_ref(a, b), atol=1e-4, rtol=1e-4)
    at, bt = (x.transpose(0, 1).contiguous().transpose(0, 1) for x in (a, b))
    torch.testing.assert_close(rglru_scan(at, bt), want, atol=1e-4, rtol=1e-4)


def test_rglru_scan_kernel_rejects_mixed_dtypes_and_devices(cuda):
    a = torch.zeros((1, 4, 8), device=cuda)
    with pytest.raises(TypeError):
        rglru_scan(a, a.bfloat16())
    with pytest.raises(ValueError):
        rglru_scan(a, a.cpu())


@torch.no_grad()
def _draw_rglru_decays(lm, seed):
    """lam uniform in [-6, -2] and the gates drawn as ``chip_smoke.py``
    draws them, so that a_t lies in about 0.4-0.999 and h carries."""
    g = torch.Generator().manual_seed(seed)
    for bt, layer in zip(lm.block_types, lm.layers):
        if bt == "rglru":
            p = layer.rglru
            p.lam.uniform_(-6.0, -2.0, generator=g)
            p.gate_a_b.normal_(0.0, 0.5, generator=g)
            p.gate_a_w.normal_(0.0, 0.001, generator=g)
            p.gate_i_b.normal_(0.0, 0.5, generator=g)
            p.gate_i_w.normal_(0.0, 0.5, generator=g)


def test_recurrentgemma_lm_on_card(cuda):
    """One (rglru, rglru, local_attn) period of the smoke config: a prompt
    that fills the window of 16, then 3 greedy decode steps that wrap the
    ring, on the card against the CPU; 2 rglru_scan and 1 flash launches
    per prefill, none per decode step."""
    cfg = get_smoke("recurrentgemma_2b").replace(n_layers=3, dtype="float32")
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    _draw_rglru_decays(cpu, seed=1)
    gpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (3, 16)))
    before = (rglru_scan.launches, flash_attention.launches)
    with torch.inference_mode():
        lg, cache = gpu.prefill(toks.to(cuda), max_len=24)
        want, want_cache = cpu.prefill(toks, max_len=24)
        torch.testing.assert_close(lg.cpu(), want, atol=1e-3, rtol=1e-3)
        for t in range(3):
            nxt = want.argmax(-1)
            assert torch.equal(lg.argmax(-1).cpu(), nxt)
            lg, cache = gpu.decode_step(cache, nxt.to(cuda), 16 + t)
            want, want_cache = cpu.decode_step(want_cache, nxt, 16 + t)
            torch.testing.assert_close(lg.cpu(), want, atol=1e-3, rtol=1e-3)
    assert (rglru_scan.launches - before[0], flash_attention.launches - before[1]) == (2, 1)
    assert cache["stack0"]["b2_local_attn"]["pos"][0].tolist() == [16, 17, 18] + list(range(3, 16))


# ---------------------------------------------------------------------------
# PipelinedModel (one stream per module lane) and the request server
# ---------------------------------------------------------------------------


def _cnn_on_card(net: str, tgt: str, n: int):
    """``net`` on ``tgt`` on the card and ``n`` requests, each run once by
    ``CompiledModel.run``: those outputs, checked bit-exact with the CPU
    interpreter, are what the compiled paths are held to."""
    g = mlperf_tiny_networks()[net]
    params = init_graph_params(g)
    rng = np.random.default_rng(3)
    xs = [{k: rng.integers(-128, 128, s).astype(np.float32) for k, s in g.inputs.items()} for _ in range(n)]
    cm = lower(dispatch(g, _target(tgt), budget=300))
    dev_params = params_to_torch(params, cm.device)
    refs = [cm.run(dev_params, x) for x in xs]
    cpu_params = params_to_torch(params, "cpu")
    for x, ref in zip(xs, refs):
        want = execute_graph(g, cpu_params, x, device="cpu")
        assert all(torch.equal(ref[k].cpu(), want[k]) for k in want)
    return cm, dev_params, xs, refs


def _same_rows(outs, refs):
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        for k in ref:
            assert out[k].device.type == "cuda"
            assert torch.equal(out[k], ref[k]), k


@pytest.mark.parametrize("aot", [False, True])
@pytest.mark.parametrize("net,tgt", [("DSCNN", "gap9"), ("ResNet", "diana")])
def test_pipelined_and_streamed_runs_bit_exact_over_repeats(cuda, net, tgt, aot):
    """Cross-stream lifetimes show as a wrong row only under run_stream:
    20 streamed runs of 6 inputs, 3 in flight, each bit-exact."""
    from repro_torch.pipeline import PipelinedModel

    cm, dev_params, xs, refs = _cnn_on_card(net, tgt, 6)
    pm = PipelinedModel(cm, stream_depth=3, aot=aot)
    assert len(pm.schedule.lanes()) >= 2  # cross-lane events on the path
    _same_rows([pm.run(dev_params, xs[0])], refs[:1])
    for _ in range(20):
        _same_rows(pm.run_stream(dev_params, xs), refs)


def test_chain_replays_count_the_captured_launches(cuda):
    """N inputs replay every lane chain N times: N x the GEMM launches
    the chains captured, and nothing for the capture itself."""
    from repro_torch.pipeline import PipelinedModel

    cm, dev_params, xs, refs = _cnn_on_card("DAE", "gap9", 7)
    gemms = cm.routes()["pallas_gemm"]
    pm = PipelinedModel(cm, stream_depth=2, aot=True)
    before = matmul_requant.launches
    _same_rows(pm.run_stream(dev_params, xs), refs)
    torch.cuda.synchronize()
    assert matmul_requant.launches - before == gemms * len(xs)


def test_one_captured_graph_per_batch_shape_on_card(cuda):
    from repro_torch.serve import BatchedModel

    cm, dev_params, xs, refs = _cnn_on_card("DSCNN", "gap9", 6)
    bm = BatchedModel(cm)
    _same_rows(bm.run_batch(dev_params, xs[:3]), refs[:3])
    _same_rows(bm.run_batch(dev_params, xs[3:]), refs[3:])
    assert len(bm.entry_stats()) == 1
    _same_rows(bm.run_batch(dev_params, xs[:2]), refs[:2])
    stats = bm.entry_stats()
    assert sorted(r["batch"] for r in stats) == [2, 3]
    assert all(r["compile_us"] > 0.0 for r in stats)  # a capture on the card


@pytest.mark.parametrize("mode", ["aot", "pipeline"])
@pytest.mark.parametrize("tgt", ["gap9", "ne16_octa", "h100"])
@pytest.mark.parametrize("net", ["DAE", "DSCNN"])
def test_sixteen_slot_server_bit_exact_on_card(cuda, net, tgt, mode):
    """40 requests through 16 slots (DAE's rows = the GEMM's M): every
    request served, none rejected, every row bit-exact with
    CompiledModel.run, and the GEMM and fused conv launches = their
    segments x batches, nothing else."""
    from repro_torch.serve import ModelServer

    cm, dev_params, xs, refs = _cnn_on_card(net, tgt, 40)
    with ModelServer(cm, dev_params, batch_slots=16, stream_depth=2, mode=mode) as srv:
        srv.warmup(xs[0])
        torch.cuda.synchronize()
        before = _graphs.launch_counts()
        outs = [h.result(timeout=120) for h in [srv.submit(x) for x in xs]]
    torch.cuda.synchronize()
    _same_rows(outs, refs)
    stats = srv.stats()
    assert stats["completed"] == len(xs) and not stats["rejected"] and stats["drained"]
    assert _launched_since(before) == _cnn_launches(cm, stats["batches"])
    cm.attrs.pop("serve")


def test_pipeline_spans_on_card_are_timed_by_cuda_events(cuda):
    """Traced, every step of every input gets a ``pipeline:<module>`` span
    from its CUDA event pair, written after the input completed; the
    outputs stay bit-exact."""
    from repro_torch import obs
    from repro_torch.pipeline import PipelinedModel

    cm, dev_params, xs, refs = _cnn_on_card("DSCNN", "gap9", 3)
    pm = PipelinedModel(cm, stream_depth=2)
    tr = obs.get_tracer()
    was = tr.enabled
    tr.enabled = True
    tr.clear()
    try:
        _same_rows(pm.run_stream(dev_params, xs), refs)
        events = tr.chrome_trace()["traceEvents"]
    finally:
        tr.enabled = was
        tr.clear()
    spans = {e["name"]: e for e in events if e.get("ph") == "X" and e.get("cat") == "runtime"}
    for k in range(len(xs)):
        for ls in cm.segments:
            span = spans[f"{ls.output_name}@{k}"]
            assert span["dur"] >= 0.0 and span["args"]["input"] == k
