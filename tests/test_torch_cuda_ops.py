"""``repro_torch.kernels.ops`` on the CUDA card: each scheduled wrapper at
small shapes that are not tile multiples launches its kernel once (counted)
and agrees with the kernel's plain version (``matmul_requant`` bit-exact,
f32 flash 2e-5, bf16 2e-2, ``moe_gmm`` 1e-4, ``rglru_scan`` 1e-4,
``ssd_scan`` 2e-4 on y and the final state).  Marked ``cuda``; without a
card each test skips (decided inside the fixture, never at import)."""

import numpy as np
import pytest
import torch

from repro_torch import _graphs
from repro_torch.kernels import (
    flash_attention_plain,
    matmul_requant_plain,
    moe_gmm_plain,
    ops,
    rglru_scan_plain,
    ssd_scan_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _launched(fn, kernel: str):
    for f in _graphs.COUNTED:
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = _graphs.launch_counts()
    assert counts == {k: int(k == kernel) for k in counts}, counts
    return out


def _close(got, want, tol):
    assert got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    assert not bool((diff > tol + tol * want.float().abs()).any()), float(diff.max())


@pytest.mark.parametrize("M,K,N", [(48, 80, 112), (600, 96, 70)])
@pytest.mark.parametrize("rounding", ["floor", "even"])
def test_scheduled_matmul_requant(cuda, M, K, N, rounding):
    rng = np.random.default_rng(M + N)
    a = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8)).to(cuda)
    w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8)).to(cuda)
    mult = torch.from_numpy(rng.integers(1, 8, (N,)).astype(np.int32)).to(cuda)
    bias = torch.from_numpy(rng.integers(-1000, 1000, (N,)).astype(np.int32)).to(cuda)
    got = _launched(lambda: ops.scheduled_matmul_requant(a, w, mult, bias, shift=9, rounding=rounding),
                    "matmul_requant")
    assert torch.equal(got, matmul_requant_plain(a, w, mult, bias, shift=9, rounding=rounding))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Sq,Sk", [(40, 40), (24, 70)])
def test_scheduled_flash_attention(cuda, dtype, tol, Sq, Sk):
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk)
    q = torch.randn(2, 4, Sq, 24, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(2, 2, Sk, 24, generator=g, device=cuda).to(dtype) for _ in range(2))
    got = _launched(lambda: ops.scheduled_flash_attention(q, k, v, q_offset=Sk - Sq), "flash_attention")
    _close(got, flash_attention_plain(q, k, v, q_offset=Sk - Sq), tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_scheduled_moe_gmm(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(3, 10, 24, generator=g, device=cuda).to(dtype)
    w = (torch.randn(3, 24, 40, generator=g, device=cuda) / 5).to(dtype)
    _close(_launched(lambda: ops.scheduled_moe_gmm(x, w), "moe_gmm"), moe_gmm_plain(x, w), tol)


def test_scheduled_rglru_scan(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    a = torch.rand(2, 137, 48, generator=g, device=cuda) * 0.79 + 0.2
    b = torch.randn(2, 137, 48, generator=g, device=cuda)
    _close(_launched(lambda: ops.scheduled_rglru_scan(a, b), "rglru_scan"), rglru_scan_plain(a, b), 1e-4)


@pytest.mark.parametrize("B,H,T", [(2, 3, 40), (1, 8, 200)])
def test_scheduled_ssd_scan(cuda, B, H, T):
    g = torch.Generator(device=cuda).manual_seed(T)
    xb = torch.randn(B, H, T, 8, generator=g, device=cuda)
    a = -torch.rand(B, H, T, generator=g, device=cuda) * 0.2
    Bm, Cm = (torch.randn(B, T, 16, generator=g, device=cuda) / 4 for _ in range(2))
    y, h = _launched(lambda: ops.scheduled_ssd_scan(xb, a, Bm, Cm), "ssd_scan")
    y_want, h_want = ssd_scan_plain(xb, a, Bm, Cm)
    _close(y, y_want, 2e-4)
    _close(h, h_want, 2e-4)
