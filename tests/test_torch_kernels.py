"""The port's kernels on the CPU, bit-exact against the JAX reference.

``matmul_requant`` on a CPU tensor computes its plain int32 version, the
arithmetic the CUDA kernel is held to on the card
(``tests/test_torch_cuda.py``).  The JAX kernel runs in Pallas interpret
mode, as the reference's own tests run it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import matmul_requant as jax_matmul_requant
from repro.kernels import tiled_conv2d as jax_tiled_conv2d
from repro.kernels.matmul_requant import _round_shift_even as jax_round_shift_even
from repro.kernels.ref import matmul_requant_ref as jax_matmul_requant_ref
from repro_torch.kernels import matmul_requant, matmul_requant_plain, ref, tiled_conv2d
from repro_torch.kernels.matmul_requant import round_shift_even

GRID = [(8, 16, 128), (32, 64, 128), (128, 128, 256), (16, 96, 384)]  # tests/test_kernels.py
MAIN_KN = [(640, 128), (128, 128), (128, 8), (8, 128), (128, 640), (64, 10), (256, 2), (64, 12)]
RAGGED = [(3, 37, 11), (48, 80, 112)]


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    mult = rng.integers(1, 8, (n,)).astype(np.int32)
    bias = rng.integers(-1000, 1000, (n,)).astype(np.int32)
    return a, w, mult, bias


def _port(a, w, mult, bias, **kw):
    t = [torch.from_numpy(v) for v in (a, w, mult, bias)]
    return matmul_requant(*t, **kw).numpy()


@pytest.mark.parametrize("rounding", ["floor", "even"])
@pytest.mark.parametrize("shift,relu", [(8, False), (5, True)])
@pytest.mark.parametrize("M,K,N", GRID)
def test_matmul_requant_grid_matches_jax_kernel(M, K, N, shift, relu, rounding):
    a, w, mult, bias = _operands(M, K, N, seed=M + K + N)
    want = jax_matmul_requant(
        a, w, mult, bias, shift=shift, relu=relu, rounding=rounding,
        block_m=8, block_n=128, block_k=16, interpret=True,
    )
    got = _port(a, w, mult, bias, shift=shift, relu=relu, rounding=rounding)
    assert got.dtype == np.int8
    assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("rounding", ["floor", "even"])
@pytest.mark.parametrize("K,N", MAIN_KN)
def test_matmul_requant_main_path_shapes_match_jax_kernel(K, N, rounding):
    a, w, mult, bias = _operands(1, K, N, seed=K * N)
    for relu in (False, True):
        want = jax_matmul_requant(
            a, w, mult, bias, shift=5, relu=relu, rounding=rounding,
            block_m=1, block_n=N, block_k=K, interpret=True,
        )
        got = _port(a, w, mult, bias, shift=5, relu=relu, rounding=rounding)
        assert np.array_equal(got, np.asarray(want)), relu


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("M,K,N", RAGGED)
def test_matmul_requant_ragged_floor_matches_jax_oracle(M, K, N, relu):
    a, w, mult, bias = _operands(M, K, N, seed=K)
    want = jax_matmul_requant_ref(a, w, mult, bias, shift=8, relu=relu)
    got = _port(a, w, mult, bias, shift=8, relu=relu, rounding="floor")
    assert np.array_equal(got, np.asarray(want))
    t = [torch.from_numpy(v) for v in (a, w, mult, bias)]
    assert np.array_equal(ref.matmul_requant_ref(*t, shift=8, relu=relu).numpy(), np.asarray(want))


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("M,K,N", RAGGED)
def test_matmul_requant_ragged_even_matches_interpreter_requant(M, K, N, relu):
    """Even mode against the interpreter's requant formula,
    clip(round_half_even((acc*M + B) / 2^S)) in exact float64."""
    a, w, mult, bias = _operands(M, K, N, seed=K)
    y = (a.astype(np.float64) @ w.astype(np.float64)) * mult + bias
    want = np.clip(np.round(y / 2.0**5), -128, 127)
    if relu:
        want = np.maximum(want, 0)
    got = _port(a, w, mult, bias, shift=5, relu=relu, rounding="even")
    assert np.array_equal(got, want.astype(np.int8))


def test_matmul_requant_takes_strided_weights():
    """The lowering passes the (K, N) transposed view of an (N, K) weight."""
    a, w, mult, bias = _operands(2, 40, 12, seed=3)
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).T  # (K, N), strides (1, K)
    assert not wt.is_contiguous()
    got = matmul_requant(torch.from_numpy(a), wt, torch.from_numpy(mult), torch.from_numpy(bias), shift=6)
    want = matmul_requant_plain(*[torch.from_numpy(v) for v in (a, w, mult, bias)], shift=6)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shift", [0, 1, 2, 5, 13, 30, 31])
def test_round_shift_even_matches_jax(shift):
    rng = np.random.default_rng(shift)
    t = np.concatenate([
        rng.integers(-(2**31), 2**31, 4000, dtype=np.int64).astype(np.int32),
        np.array([-(2**31), 2**31 - 1, 0, -1, 1, min(2**shift, 2**31 - 1), -(2**shift)], np.int32),
        (np.arange(-64, 64, dtype=np.int32) << max(shift - 1, 0)),
    ])
    want = np.asarray(jax_round_shift_even(jnp.asarray(t), shift))
    got = round_shift_even(torch.from_numpy(t), shift).numpy()
    assert np.array_equal(got, want)


def _conv_case(x, w, stride, block_oy, groups):
    want = jax_tiled_conv2d(
        jnp.asarray(x), jnp.asarray(w), stride=stride, block_oy=block_oy, feature_groups=groups
    )
    got = tiled_conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=stride,
                       block_oy=block_oy, feature_groups=groups)
    assert tuple(got.shape) == tuple(want.shape)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("block_oy", [1, 3, 5, 25])
def test_tiled_conv_dscnn_4x10_stride2_matches_jax(block_oy):
    rng = np.random.default_rng(1)
    x = rng.integers(-128, 128, (1, 49, 10, 1)).astype(np.float32)
    w = rng.integers(-4, 5, (10, 4, 1, 16)).astype(np.float32)
    _conv_case(x, w, 2, block_oy, 1)


@pytest.mark.parametrize("block_oy", [0, 7])
def test_tiled_conv_mobilenet_3x3_stride2_matches_jax(block_oy):
    rng = np.random.default_rng(2)
    x = rng.integers(-128, 128, (1, 96, 96, 3)).astype(np.float32)
    w = rng.integers(-4, 5, (3, 3, 3, 8)).astype(np.float32)
    _conv_case(x, w, 2, block_oy, 1)


@pytest.mark.parametrize("stride,block_oy", [(1, 4), (2, 0), (2, 3)])
def test_tiled_conv_depthwise_matches_jax(stride, block_oy):
    rng = np.random.default_rng(3)
    x = rng.integers(-128, 128, (1, 24, 24, 8)).astype(np.float32)
    w = rng.integers(-4, 5, (3, 3, 1, 8)).astype(np.float32)
    _conv_case(x, w, stride, block_oy, 8)


def test_tiled_conv_banding_matches_whole_array_conv():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-128, 128, (2, 13, 11, 4)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-4, 5, (3, 5, 4, 6)).astype(np.float32))
    whole = tiled_conv2d(x, w, stride=2)
    for block_oy in (1, 2, 3, 6):
        assert torch.equal(tiled_conv2d(x, w, stride=2, block_oy=block_oy), whole)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    assert np.array_equal(whole.numpy(), np.asarray(ref))
