"""The LM kernels' backwards on the CUDA card, and a train step through them.

Each kernel wrapper, given CUDA inputs with grad enabled and an input that
needs a gradient, goes through its ``autograd.Function`` (the kernel
forward, the explicit ``*_backward``): its output carries that Function's
grad_fn, and its gradients are held against ``torch.autograd.grad`` of the
plain version on the card, over the cases of
``tests/test_torch_grad_kernels.py``, within 1e-4 of the largest |plain
gradient| in float32 and 2e-2 in bfloat16 (the kernels' forward
tolerances).  Then a 2-layer fp32 LM of each kernel's family: every
parameter's gradient on the card against the same module on the CPU
(plain versions) within 1e-3 of the leaf's largest |gradient|, nonzero
wherever the CPU's is.  Marked ``cuda``; without a card each test skips
(decided inside the fixture, never at import).
"""

import copy
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.models import LM

fa, mg, rg, ss = (importlib.import_module(f"repro_torch.kernels.{m}")
                  for m in ("flash_attention", "moe_gmm", "rglru_scan", "ssd_scan"))

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _t(rng, shape, dev, dtype=torch.float32, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dev, dtype)


def _grads(fn, inputs, douts):
    inputs = [x.detach().clone().requires_grad_(True) for x in inputs]
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, d) for o, d in zip(outs, douts) if d is not None]
    grads = torch.autograd.grad([o for o, _ in pairs], inputs, [d for _, d in pairs], allow_unused=True)
    return outs, [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]


def _check(kernel, plain, inputs, douts, fn_name, tol):
    outs, got = _grads(kernel, inputs, douts)
    assert type(outs[0].grad_fn).__name__ == f"{fn_name}Backward", type(outs[0].grad_fn).__name__
    _, want = _grads(plain, [x.float() for x in inputs], [None if d is None else d.float() for d in douts])
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        err = float((g.float() - w).abs().max())
        assert err <= tol * max(float(w.abs().max()), 1e-30), (err, float(w.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [
    (2, 4, 2, 64, 64, 32, True, 0, None), (1, 4, 1, 96, 96, 16, True, 0, 24), (2, 4, 4, 40, 40, 16, False, 0, None),
    (1, 16, 2, 128, 128, 128, True, 0, None), (2, 4, 2, 24, 64, 16, True, 40, None),
], ids=["causal", "windowed", "non-causal", "gqa-16-over-2", "sq-ne-sk-offset"])
def test_flash_attention_function(cuda, case, dtype):
    B, H, KV, Sq, Sk, D, causal, off, win = case
    rng = np.random.default_rng(Sq + Sk)
    q, k, v = _t(rng, (B, H, Sq, D), cuda, dtype), _t(rng, (B, KV, Sk, D), cuda, dtype), _t(rng, (B, KV, Sk, D), cuda, dtype)
    do = _t(rng, (B, H, Sq, D), cuda, dtype)
    kw = dict(causal=causal, q_offset=off, window=win)
    _check(lambda q, k, v: fa.flash_attention(q, k, v, **kw), lambda q, k, v: fa.flash_attention_plain(q, k, v, **kw),
           [q, k, v], [do], "_FlashAttention", TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("E,C,D,F", [(40, 32, 1536, 512), (40, 32, 512, 1536), (3, 7, 5, 9)],
                         ids=["granite-wi", "granite-wo", "ragged"])
def test_moe_gmm_function(cuda, E, C, D, F, dtype):
    rng = np.random.default_rng(E + C + D + F)
    x, w, dy = _t(rng, (E, C, D), cuda, dtype), _t(rng, (E, D, F), cuda, dtype, D**-0.5), _t(rng, (E, C, F), cuda, dtype)
    before = mg.moe_gmm.launches
    _check(mg.moe_gmm, mg.moe_gmm_plain, [x, w], [dy], "_MoeGmm", TOL[dtype])
    assert mg.moe_gmm.launches == before + 3  # the forward, dx and dw


@pytest.mark.parametrize("B,T,W", [(2, 128, 64), (1, 512, 2560), (3, 37, 45)], ids=["T128", "T512", "ragged"])
def test_rglru_scan_function(cuda, B, T, W):
    rng = np.random.default_rng(T + W)
    a = torch.from_numpy(rng.uniform(0.4, 0.9999, (B, T, W)).astype(np.float32)).to(cuda)
    b, dh = _t(rng, (B, T, W), cuda), _t(rng, (B, T, W), cuda)
    before = rg.rglru_scan.launches
    _check(rg.rglru_scan, rg.rglru_scan_plain, [a, b], [dh], "_RgLruScan", TOL[torch.float32])
    assert rg.rglru_scan.launches == before + 2  # the forward and the reversed scan


@pytest.mark.parametrize("case", [(2, 3, 128, 8, 16), (1, 4, 512, 64, 128), (2, 2, 300, 16, 32)],
                         ids=["T128", "T512", "ragged"])
def test_ssd_scan_function(cuda, case):
    B, H, T, P, N = case
    rng = np.random.default_rng(T + H)
    xb, Bm, Cm = _t(rng, (B, H, T, P), cuda), _t(rng, (B, T, N), cuda, scale=0.5), _t(rng, (B, T, N), cuda, scale=0.5)
    a = torch.from_numpy(rng.uniform(-0.2, 0.0, (B, H, T)).astype(np.float32)).to(cuda)
    dy, dh = _t(rng, (B, H, T, P), cuda), _t(rng, (B, H, P, N), cuda)
    _check(ss.ssd_scan, ss.ssd_scan_plain, [xb, a, Bm, Cm], [dy, dh], "_SsdScan", 2e-4)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "granite_moe_3b_a800m", "mamba2_1_3b", "recurrentgemma_2b",
                                  "qwen2_vl_2b", "hubert_xlarge"])
def test_lm_gradients_on_card_match_cpu(cuda, arch):
    cfg = get_smoke(arch).replace(n_layers=min(get_smoke(arch).n_layers, 3), dtype="float32")
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(0)
    if cfg.frontend_stub:
        batch = {"embeds": torch.from_numpy(rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32))}
    else:
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))}
    batch["labels"] = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32)))
    grads = []
    for lm, dev in ((cpu, "cpu"), (gpu, cuda)):
        params = list(lm.parameters())
        lm.requires_grad_(True)
        loss = lm.loss({k: v.to(dev) for k, v in batch.items()})
        grads.append([None if g is None else g.cpu() for g in torch.autograd.grad(loss, params, allow_unused=True)])
    for name, g_cpu, g_gpu in zip(dict(cpu.named_parameters()), *grads):
        if g_cpu is None or not g_cpu.any():
            continue  # a parameter the loss does not reach (hubert's token embedding)
        assert g_gpu is not None and g_gpu.any(), f"{name}: no gradient on the card"
        err = float((g_gpu - g_cpu).abs().max())
        assert err <= 1e-3 * float(g_cpu.abs().max()), (name, err)
