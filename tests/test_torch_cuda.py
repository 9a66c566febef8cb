"""The port on the CUDA card: the Hopper kernel against its plain version,
and one net through the main path bit-exact.  Marked ``cuda``; without a
card each test skips (decided inside the fixture, never at import)."""

import numpy as np
import pytest
import torch

from repro_torch.backend import lower
from repro_torch.cnn import execute_graph, init_graph_params, mlperf_tiny_networks, params_to_torch
from repro_torch.core import dispatch
from repro_torch.kernels import matmul_requant, matmul_requant_plain

pytestmark = pytest.mark.cuda

SHAPES = [(1, 640, 128), (1, 128, 8), (1, 256, 2), (1, 64, 12), (8, 16, 128), (128, 128, 256), (3, 37, 11), (48, 80, 112)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_kernel_matches_plain_version(cuda, M, K, N, transposed):
    rng = np.random.default_rng(M * K + N)
    a = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)).to(cuda)
    if transposed:  # the (K, N) view of an (N, K) weight, as the lowering passes it
        w = torch.from_numpy(rng.integers(-128, 128, (N, K)).astype(np.int8)).to(cuda).T
    else:
        w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8)).to(cuda)
    mult = torch.from_numpy(rng.integers(1, 8, (N,)).astype(np.int32)).to(cuda)
    bias = torch.from_numpy(rng.integers(-1000, 1000, (N,)).astype(np.int32)).to(cuda)
    for rounding in ("floor", "even"):
        for relu in (False, True):
            before = matmul_requant.launches
            got = matmul_requant(a, w, mult, bias, shift=5, relu=relu, rounding=rounding)
            torch.cuda.synchronize()
            assert matmul_requant.launches == before + 1
            want = matmul_requant_plain(a, w, mult, bias, shift=5, relu=relu, rounding=rounding)
            assert torch.equal(got, want), (rounding, relu)


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
