"""The port on the CUDA card: the Hopper kernels against their plain
versions, one net through the CNN main path bit-exact, a 2-layer LM
whose prefill goes through the flash kernel, 2-layer MoE and mamba2
LMs through ``moe_gmm`` and ``ssd_scan``, and a 3-layer recurrentgemma
LM through ``rglru_scan`` and the windowed flash kernel.  Marked ``cuda``; without a
card each test skips (decided inside the fixture, never at import)."""

import numpy as np
import pytest
import torch

from repro_torch.backend import lower
from repro_torch.cnn import execute_graph, init_graph_params, mlperf_tiny_networks, params_to_torch
from repro_torch.core import dispatch
from repro_torch.configs import get_smoke
from repro_torch.kernels import (
    flash_attention,
    flash_attention_plain,
    matmul_requant,
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


FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
FLASH_GRID = [(1, 4, 4, 64, 64, 32), (2, 8, 2, 128, 128, 64), (1, 6, 1, 96, 96, 16), (4, 16, 2, 24, 24, 128),
              (1, 4, 2, 37, 37, 256), (2, 4, 1, 5, 5, 24)]


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
    q, k, v = _qkv(cuda, B, H, KV, Sq, Sk, D, dtype, seed=Sq * D, bshd=D == 128)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.stride() == q.stride()
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_TOL[dtype], rtol=FLASH_TOL[dtype])


@pytest.mark.parametrize(
    "Sq,Sk,q_offset,causal,window",
    [(16, 64, 48, True, None), (64, 64, 0, True, 16), (32, 64, 32, True, 8), (64, 64, 0, False, 24),
     (8, 32, 100, True, 4), (1, 200, 199, True, None), (40, 300, 260, True, 70)],
)
def test_flash_kernel_offset_and_window(cuda, Sq, Sk, q_offset, causal, window):
    q, k, v = _qkv(cuda, 2, 4, 2, Sq, Sk, 32, torch.float32, seed=Sq + Sk)
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset, window=window)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


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


GMM_SHAPES = [(2, 16, 32, 64), (8, 64, 128, 128), (3, 8, 16, 384), (3, 37, 45, 70), (5, 1, 7, 3),
              (40, 32, 1536, 512), (40, 32, 512, 1536)]


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
    # x as the (E, C, D) view of (C, E, D) storage
    xt = x.transpose(0, 1).contiguous().transpose(0, 1)
    torch.testing.assert_close(moe_gmm(xt, w).float(), moe_gmm_plain(x, w).float(), atol=tol, rtol=tol)


SSD_SHAPES = [(1, 2, 32, 8, 16), (2, 4, 64, 16, 32), (1, 3, 37, 8, 16), (2, 2, 5, 16, 16), (4, 64, 24, 64, 128),
              (1, 64, 200, 64, 128)]


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,P,N", SSD_SHAPES)
def test_ssd_scan_kernel_matches_plain_version(cuda, B, H, T, P, N, bc_dtype):
    rng = np.random.default_rng(T * P + N)
    # (B, T, H, P) storage handed over as (B, H, T, P) views, as the model does
    xb = torch.from_numpy(rng.normal(size=(B, T, H, P)).astype(np.float32)).to(cuda).transpose(1, 2)
    a = torch.from_numpy((-np.abs(rng.normal(size=(B, T, H))) * 0.2).astype(np.float32)).to(cuda).transpose(1, 2)
    Bm, Cm = (torch.from_numpy((rng.normal(size=(B, T, N)) / np.sqrt(N)).astype(np.float32)).to(cuda, bc_dtype)
              for _ in range(2))
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


RGLRU_SHAPES = [(1, 32, 16), (2, 128, 64), (3, 64, 256), (2, 37, 45), (1, 5, 3), (4, 24, 2560), (1, 300, 2560)]


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
