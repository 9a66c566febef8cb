"""Each LM kernel's backward on the CPU against autograd of its plain version.

``flash_attention_backward``, ``moe_gmm_backward``, ``rglru_scan_backward``
and ``ssd_scan_backward`` are explicit adjoints (``repro_torch.kernels``);
``moe_gmm``'s and ``rglru_scan``'s call their own kernels' wrappers, which
on CPU tensors take the plain versions.  Each is held against
``torch.autograd.grad`` of the kernel's plain version on the same inputs
and output gradient, made with numpy from a seed, over the cases the
card's check lists: flash causal, windowed, non-causal, GQA, Sq != Sk
with ``q_offset`` and rows with no valid key; granite-moe's wi and wo
shapes; the scans at T = 128, 512 and a ragged T, with slow decays (and
``ssd_scan`` with a gradient of its final state too).  Float32, within
1e-5 of the largest |plain gradient|.  The ``autograd.Function`` each
wrapper takes on the card under grad runs here too, through the plain
forward, and gives the same gradients.
"""

import importlib

import numpy as np
import pytest
import torch

# the kernel modules (the package exports the wrappers under the same names)
fa, mg, rg, ss = (importlib.import_module(f"repro_torch.kernels.{m}")
                  for m in ("flash_attention", "moe_gmm", "rglru_scan", "ssd_scan"))

TOL = 1e-5


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _check(mine, want):
    for m, w in zip(mine, want):
        assert m.shape == w.shape and m.dtype == w.dtype
        err = float((m - w).abs().max())
        assert err <= TOL * max(float(w.abs().max()), 1e-30), (err, float(w.abs().max()))


def _plain_grads(fn, inputs, douts):
    inputs = [x.clone().requires_grad_(True) for x in inputs]
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, d) for o, d in zip(outs, douts) if d is not None]
    grads = torch.autograd.grad([o for o, _ in pairs], inputs, [d for _, d in pairs], allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]


FLASH = {  # B, H, KV, Sq, Sk, D, causal, q_offset, window
    "causal": (2, 4, 2, 64, 64, 32, True, 0, None),
    "windowed": (1, 4, 1, 96, 96, 16, True, 0, 24),
    "non-causal": (2, 4, 4, 40, 40, 16, False, 0, None),
    "gqa-16-over-2": (1, 16, 2, 32, 32, 16, True, 0, None),
    "sq-ne-sk-offset": (2, 4, 2, 24, 64, 16, True, 40, None),
    "no-valid-key-rows": (1, 4, 2, 6, 10, 8, True, -3, None),
}


@pytest.mark.parametrize("case", list(FLASH))
def test_flash_attention_backward(case):
    B, H, KV, Sq, Sk, D, causal, off, win = FLASH[case]
    rng = np.random.default_rng(len(case))
    q, k, v, do = _t(rng, B, H, Sq, D), _t(rng, B, KV, Sk, D), _t(rng, B, KV, Sk, D), _t(rng, B, H, Sq, D)
    kw = dict(causal=causal, q_offset=off, window=win)
    want = _plain_grads(lambda q, k, v: fa.flash_attention_plain(q, k, v, **kw), [q, k, v], [do])
    _check(fa.flash_attention_backward(q, k, v, do, **kw), want)
    _check(_plain_grads(lambda q, k, v: fa._FlashAttention.apply(q, k, v, causal, off, win), [q, k, v], [do]), want)


@pytest.mark.parametrize("E,C,D,F", [(40, 32, 1536, 512), (40, 32, 512, 1536), (3, 7, 5, 9)],
                         ids=["granite-wi", "granite-wo", "ragged"])
def test_moe_gmm_backward(E, C, D, F):
    rng = np.random.default_rng(E + C + D + F)
    x, w, dy = _t(rng, E, C, D), _t(rng, E, D, F, scale=D**-0.5), _t(rng, E, C, F)
    want = _plain_grads(mg.moe_gmm_plain, [x, w], [dy])
    _check(mg.moe_gmm_backward(x, w, dy), want)
    _check(_plain_grads(mg._MoeGmm.apply, [x, w], [dy]), want)
    assert mg.moe_gmm_backward(x, w, dy, need_dx=False)[0] is None


def _decays(rng, *shape, lo):
    return torch.from_numpy(rng.uniform(lo, 0.9999, shape).astype(np.float32))


@pytest.mark.parametrize("B,T,W", [(2, 128, 64), (1, 512, 32), (3, 37, 45), (1, 1, 8)],
                         ids=["T128", "T512", "ragged", "T1"])
def test_rglru_scan_backward(B, T, W):
    rng = np.random.default_rng(T + W)
    a, b, dh = _decays(rng, B, T, W, lo=0.4), _t(rng, B, T, W), _t(rng, B, T, W)
    want = _plain_grads(rg.rglru_scan_plain, [a, b], [dh])
    h = rg.rglru_scan_plain(a, b)
    _check(rg.rglru_scan_backward(a, h, dh), want)
    _check(_plain_grads(rg._RgLruScan.apply, [a, b], [dh]), want)


SSD = {  # B, H, T, P, N, slowest decay
    "T128": (2, 3, 128, 8, 16, -0.2),
    "T512-four-chunks": (1, 2, 512, 8, 16, -0.2),
    "ragged-T300": (2, 2, 300, 8, 16, -0.2),
    "slow-decays-T640": (1, 2, 640, 4, 8, -0.005),
    "short-T5": (1, 2, 5, 4, 8, -0.2),
}


@pytest.mark.parametrize("with_final", [False, True], ids=["y", "y-and-h_final"])
@pytest.mark.parametrize("case", list(SSD))
def test_ssd_scan_backward(case, with_final):
    B, H, T, P, N, lo = SSD[case]
    rng = np.random.default_rng(T + H)
    xb, Bm, Cm = _t(rng, B, H, T, P), _t(rng, B, T, N, scale=0.5), _t(rng, B, T, N, scale=0.5)
    a = torch.from_numpy(rng.uniform(lo, 0.0, (B, H, T)).astype(np.float32))
    dy = _t(rng, B, H, T, P)
    dh = _t(rng, B, H, P, N) if with_final else None
    want = _plain_grads(ss.ssd_scan_plain, [xb, a, Bm, Cm], [dy, dh])
    _check(ss.ssd_scan_backward(xb, a, Bm, Cm, dy, dh), want)
    _check(_plain_grads(ss._SsdScan.apply, [xb, a, Bm, Cm], [dy, dh]), want)


def test_backward_counts_its_calls():
    rng = np.random.default_rng(0)
    a, b = _decays(rng, 1, 4, 3, lo=0.5), _t(rng, 1, 4, 3)
    before = rg.rglru_scan_backward.calls, rg.rglru_scan.launches
    rg.rglru_scan_backward(a, rg.rglru_scan_plain(a, b), b)
    assert (rg.rglru_scan_backward.calls, rg.rglru_scan.launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize("name", ["flash_attention", "moe_gmm", "rglru_scan", "ssd_scan"])
def test_wrapper_on_cpu_under_grad_is_the_plain_version(name):
    """On CPU tensors the wrappers take the plain versions, which autograd
    follows: the output carries a grad_fn of the plain ops, not the
    kernel's Function."""
    rng = np.random.default_rng(1)
    args = {
        "flash_attention": lambda: (fa.flash_attention, [_t(rng, 1, 2, 4, 8), _t(rng, 1, 1, 4, 8), _t(rng, 1, 1, 4, 8)]),
        "moe_gmm": lambda: (mg.moe_gmm, [_t(rng, 2, 3, 4), _t(rng, 2, 4, 5)]),
        "rglru_scan": lambda: (rg.rglru_scan, [_decays(rng, 1, 4, 3, lo=0.5), _t(rng, 1, 4, 3)]),
        "ssd_scan": lambda: (ss.ssd_scan, [_t(rng, 1, 2, 4, 3), -torch.rand(1, 2, 4), _t(rng, 1, 4, 5), _t(rng, 1, 4, 5)]),
    }[name]
    fn, inputs = args()
    out = fn(*[x.requires_grad_(True) for x in inputs])
    out = out[0] if isinstance(out, tuple) else out
    assert out.grad_fn is not None and "BackwardCFunction" not in type(out.grad_fn).__name__


def _float64_case(name, rng):
    """(the plain version on float64 inputs, the same function written
    directly in float64 numpy)."""
    f = lambda *shape: rng.standard_normal(shape)  # noqa: E731
    if name == "flash_attention":
        q, k, v = f(2, 4, 12, 8), f(2, 2, 12, 8), f(2, 2, 12, 8)
        kk, vv = np.repeat(k, 2, axis=1), np.repeat(v, 2, axis=1)
        s = np.einsum("bhqd,bhkd->bhqk", q, kk) / np.sqrt(8)
        s = np.where(np.tril(np.ones((12, 12), bool)), s, -np.inf)
        p = np.exp(s - s.max(-1, keepdims=True))
        want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), vv)
        return fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal=True), want
    if name == "moe_gmm":
        x, w = f(3, 5, 7), f(3, 7, 4)
        return mg.moe_gmm_plain(torch.from_numpy(x), torch.from_numpy(w)), np.einsum("ecd,edf->ecf", x, w)
    if name == "rglru_scan":
        a, b = rng.uniform(0.4, 0.999, (2, 20, 6)), f(2, 20, 6)
        h, hs = np.zeros((2, 6)), []
        for t in range(20):
            h = a[:, t] * h + b[:, t]
            hs.append(h)
        return rg.rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(b)), np.stack(hs, 1)
    xb, a, Bm, Cm = f(1, 2, 70, 4), rng.uniform(-0.3, 0.0, (1, 2, 70)), f(1, 70, 8), f(1, 70, 8)
    h, ys = np.zeros((1, 2, 4, 8)), []
    for t in range(70):
        h = np.exp(a[:, :, t])[..., None, None] * h + xb[:, :, t, :, None] * Bm[:, None, t, None, :]
        ys.append(np.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    y, final = ss.ssd_scan_plain(*map(torch.from_numpy, (xb, a, Bm, Cm)), chunk=32)
    return (y, final), (np.stack(ys, 2), h)


@pytest.mark.parametrize("name", ["flash_attention", "moe_gmm", "rglru_scan", "ssd_scan"])
def test_plain_version_keeps_float64(name):
    """On float64 inputs each plain version computes in float64 (the
    float64 oracle of the card's model-level gradient check): float64
    out, within 1e-12 of the function written directly in float64, which
    a float32 computation would miss by about 1e-7."""
    got, want = _float64_case(name, np.random.default_rng(7))
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12 * np.abs(w).max())
