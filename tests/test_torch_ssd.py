"""The port's mamba2 block and ``ssd_scan`` on the CPU against the JAX package.

``ssd_scan_plain`` and the ``ssd_scan`` wrapper given CPU tensors: y
against the Pallas kernel (interpret mode, as ``tests/test_kernels.py``
runs it) and the sequential oracle ``ref.ssd_scan_ref`` at 2e-4, the
final state against the reference model's ``ssd_chunked_ref`` at 3e-4
(``test_kernels.py:57-86``), also on ragged T the Pallas kernel cannot
tile.  Then the causal conv, ``ssd_chunked_ref``, ``ssd_block`` with its
final states and ``ssd_decode_step`` against the reference, on the
mamba2 smoke config, with weights and inputs made with numpy from a seed;
float32 throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.kernels import ref as jax_ref
from repro.kernels import ssd_scan as jax_ssd_scan
from repro.models import rglru as jrglru
from repro.models import ssd as jssd
from repro_torch.configs import get_smoke
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import ssd_scan, ssd_scan_plain
from repro_torch.models import rglru as prglru
from repro_torch.models import ssd as pssd

GRID = [(1, 2, 32, 8, 16), (2, 4, 64, 16, 32)]  # tests/test_kernels.py:57
RAGGED = [(1, 3, 37, 8, 16), (2, 2, 5, 16, 16), (1, 2, 100, 16, 32)]


def _scan_inputs(B, H, T, P, N, seed):
    """The kernel test's distributions: xb, B, C normal, a = -|normal| * 0.2."""
    rng = np.random.default_rng(seed)
    xb = rng.normal(size=(B, H, T, P)).astype(np.float32)
    a = (-np.abs(rng.normal(size=(B, H, T))) * 0.2).astype(np.float32)
    Bm = rng.normal(size=(B, T, N)).astype(np.float32)
    Cm = rng.normal(size=(B, T, N)).astype(np.float32)
    return xb, a, Bm, Cm


def _final_state_ref(xb, a, Bm, Cm):
    """The reference model's (y, final state) for the kernel's inputs:
    ``ssd_chunked_ref`` with A = -1 and dt = -a, so that dt * A = a, and
    x = xb / dt, so that x * dt = xb."""
    x = jnp.asarray(xb.transpose(0, 2, 1, 3))  # (B, T, H, P)
    dt = jnp.asarray(-a.transpose(0, 2, 1))  # (B, T, H): dt * A = a with A = -1
    x = x / dt[..., None]  # so that x * dt = xb
    A = -jnp.ones((xb.shape[1],), jnp.float32)
    y, h = jssd.ssd_chunked_ref(x, dt, A, jnp.asarray(Bm), jnp.asarray(Cm), chunk=min(128, xb.shape[2]))
    return np.asarray(y).transpose(0, 2, 1, 3), np.asarray(h)


def _port_both(*args):
    before = ssd_scan.launches
    outs = {"plain": ssd_scan_plain(*args), "wrapper": ssd_scan(*args)}
    assert ssd_scan.launches == before
    return outs


@pytest.mark.parametrize("B,H,T,P,N", GRID)
def test_ssd_scan_matches_pallas_kernel_oracle_and_chunked_ref(B, H, T, P, N):
    xb, a, Bm, Cm = _scan_inputs(B, H, T, P, N, seed=T + P)
    jargs = [jnp.asarray(v) for v in (xb, a, Bm, Cm)]
    pallas = np.asarray(jax_ssd_scan(*jargs, block_t=16))
    oracle = np.asarray(jax_ref.ssd_scan_ref(*jargs))
    _, h_want = _final_state_ref(xb, a, Bm, Cm)
    targs = [torch.from_numpy(v) for v in (xb, a, Bm, Cm)]
    np.testing.assert_allclose(port_ref.ssd_scan_ref(*targs).numpy(), oracle, atol=2e-4, rtol=2e-4)
    for name, (y, h) in _port_both(*targs).items():
        assert y.dtype == h.dtype == torch.float32 and y.shape == (B, H, T, P) and h.shape == (B, H, P, N)
        np.testing.assert_allclose(y.numpy(), pallas, atol=2e-4, rtol=2e-4, err_msg=name)
        np.testing.assert_allclose(y.numpy(), oracle, atol=2e-4, rtol=2e-4, err_msg=name)
        np.testing.assert_allclose(h.numpy(), h_want, atol=3e-4, rtol=3e-4, err_msg=name)


@pytest.mark.parametrize("B,H,T,P,N", RAGGED)
def test_ssd_scan_ragged_lengths_match_oracle(B, H, T, P, N):
    """T that no 16- or 128-row chunk divides: y against the sequential
    oracle, and the final state against the chunked reference at one chunk
    of all T rows."""
    xb, a, Bm, Cm = _scan_inputs(B, H, T, P, N, seed=T)
    oracle = np.asarray(jax_ref.ssd_scan_ref(*[jnp.asarray(v) for v in (xb, a, Bm, Cm)]))
    _, h_want = _final_state_ref(xb, a, Bm, Cm)
    targs = [torch.from_numpy(v) for v in (xb, a, Bm, Cm)]
    for name, (y, h) in _port_both(*targs).items():
        np.testing.assert_allclose(y.numpy(), oracle, atol=2e-4, rtol=2e-4, err_msg=name)
        np.testing.assert_allclose(h.numpy(), h_want, atol=3e-4, rtol=3e-4, err_msg=name)
    # a chunk shorter than T, with a ragged last chunk
    y, h = ssd_scan_plain(*targs, chunk=16)
    np.testing.assert_allclose(y.numpy(), oracle, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(h.numpy(), h_want, atol=3e-4, rtol=3e-4)


def test_ssd_scan_reads_strided_views():
    """The model hands over (B, T, H, P) activations as (B, H, T, P) views."""
    xb, a, Bm, Cm = _scan_inputs(2, 3, 24, 8, 16, seed=5)
    oracle = np.asarray(jax_ref.ssd_scan_ref(*[jnp.asarray(v) for v in (xb, a, Bm, Cm)]))
    xt = torch.from_numpy(np.ascontiguousarray(xb.transpose(0, 2, 1, 3))).transpose(1, 2)
    at = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1))).transpose(1, 2)
    for name, (y, _) in _port_both(xt, at, torch.from_numpy(Bm), torch.from_numpy(Cm)).items():
        np.testing.assert_allclose(y.numpy(), oracle, atol=2e-4, rtol=2e-4, err_msg=name)


@pytest.mark.parametrize("shapes", [((1, 2, 8, 4), (1, 2, 7), (1, 8, 3)), ((1, 2, 8, 4), (1, 2, 8), (2, 8, 3))])
def test_ssd_scan_rejects_mismatched_shapes(shapes):
    xs, as_, bs = shapes
    with pytest.raises(ValueError):
        ssd_scan(torch.zeros(xs), torch.zeros(as_), torch.zeros(bs), torch.zeros(bs))


# ---------------------------------------------------------------------------
# the mamba2 block
# ---------------------------------------------------------------------------


def _cfg():
    return jax_get_smoke("mamba2_1_3b").replace(dtype="float32")


def _block_params(seed=0):
    """SSD block weights from numpy at the reference's init scales; A_log
    and dt_bias drawn too, so the decay varies by head."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in jssd.ssd_params(_cfg()).items():
        if s.init == "normal":
            out[k] = (rng.normal(size=s.shape) * s.scale / np.sqrt(s.shape[0])).astype(np.float32)
        else:
            out[k] = rng.normal(size=s.shape).astype(np.float32) * 0.5
    return out


def _jp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _pp(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _close(got, want, tol=1e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max())), rtol=tol)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 7, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state else None
    jy, js = jrglru._causal_conv1d(jnp.asarray(x), jnp.asarray(w), None if st is None else jnp.asarray(st))
    py, ps = prglru._causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), None if st is None else torch.from_numpy(st))
    _close(py, jy, 1e-6)
    _close(ps, js, 0)


@pytest.mark.parametrize("T,chunk,with_init", [(64, 16, False), (48, 48, True), (24, 8, True)])
def test_ssd_chunked_ref_matches_reference(T, chunk, with_init):
    rng = np.random.default_rng(T)
    B, H, P, N = 2, 3, 8, 16
    x = rng.normal(size=(B, T, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, T, H))) * 0.5 + 0.1).astype(np.float32)
    A = (-np.abs(rng.normal(size=(H,)))).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, T, N)).astype(np.float32) for _ in range(2))
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32) if with_init else None
    jy, jh = jssd.ssd_chunked_ref(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk,
                                  init_state=None if h0 is None else jnp.asarray(h0))
    py, ph = pssd.ssd_chunked_ref(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk=chunk,
                                  init_state=None if h0 is None else torch.from_numpy(h0))
    _close(py, jy)
    _close(ph, jh)


@pytest.mark.parametrize("T", [1, 16, 40])
def test_ssd_block_with_state_matches_reference(T):
    cfg = _cfg()
    params = _block_params(seed=T)
    x = np.random.default_rng(T + 1).normal(size=(2, T, cfg.d_model)).astype(np.float32)
    jy, jst = jssd.ssd_block(_jp(params), jnp.asarray(x), cfg, return_state=True)
    py, pst = pssd.ssd_block(_pp(params), torch.from_numpy(x), get_smoke("mamba2_1_3b").replace(dtype="float32"),
                             return_state=True)
    _close(py, jy)
    assert set(pst) == set(jst)
    for k in jst:
        _close(pst[k], jst[k])
    _close(pssd.ssd_block(_pp(params), torch.from_numpy(x), cfg), jy)


def test_ssd_decode_step_matches_reference():
    """A prefill's state carried through three decode steps."""
    cfg = _cfg()
    pcfg = get_smoke("mamba2_1_3b").replace(dtype="float32")
    params = _block_params(seed=2)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    _, jst = jssd.ssd_block(_jp(params), jnp.asarray(x), cfg, return_state=True)
    _, pst = pssd.ssd_block(_pp(params), torch.from_numpy(x), pcfg, return_state=True)
    for _ in range(3):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jy, jst = jssd.ssd_decode_step(_jp(params), jnp.asarray(xt), jst, cfg)
        py, pst = pssd.ssd_decode_step(_pp(params), torch.from_numpy(xt), pst, pcfg)
        _close(py, jy)
        for k in jst:
            _close(pst[k], jst[k])
    init = pssd.ssd_state_init(pcfg, 3)
    jinit = jssd.ssd_state_init(cfg, 3)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in init.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jinit.items()
    }


def test_ssd_block_keeps_the_reference_chunk_assertion():
    """T = 200: min(128, T) = 128 does not divide it, and both packages
    refuse (ROADMAP C-ref-5)."""
    cfg = _cfg()
    params = _block_params()
    x = np.zeros((1, 200, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jssd.ssd_block(_jp(params), jnp.asarray(x), cfg)
    with pytest.raises(AssertionError):
        pssd.ssd_block(_pp(params), torch.from_numpy(x), get_smoke("mamba2_1_3b").replace(dtype="float32"))
