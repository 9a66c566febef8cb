"""The scans' launch plan and chunked math, on the CPU.

``heads_per_block`` (``repro_torch.kernels.ssd_scan``) decides how many
heads share one output block of the SSD kernel on the card: these tests
hold it to the counts that the ``[kernels]`` sweep of ``chip_smoke.py``
timed fastest at mamba2-1.3b's shapes (H = 64) on an H100 (132 SMs), and
to its rule at other shapes and multiprocessor counts.

Then the two scans' CPU paths over many chunks, where the carried state
matters (slow decays), against the JAX package: ``ssd_scan`` and
``ssd_scan_plain`` at the kernel's 64-row chunks against the sequential
oracle ``repro.kernels.ref.ssd_scan_ref`` (y) and the reference model's
``ssd_chunked_ref`` in one chunk (final state) at 2e-4 and 3e-4, as
``tests/test_torch_ssd.py`` holds them; ``rglru_scan`` and
``rglru_scan_plain`` past several 64-step chunks against
``repro.kernels.ref.rglru_scan_ref`` at 1e-4.  Inputs are made with numpy
from a seed, in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.models import ssd as jssd
from repro_torch.kernels import rglru_scan, rglru_scan_plain, ssd_scan, ssd_scan_plain
from repro_torch.kernels.ssd_scan import heads_per_block

H100_SMS = 132


# ---------------------------------------------------------------------------
# ssd_scan: heads per output block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "B,T,chunks,heads",
    [(4, 24, 1, 2), (1, 24, 1, 1), (4, 512, 8, 8), (1, 4096, 64, 16), (1, 512, 8, 2), (1, 4095, 64, 16)],
)
def test_heads_per_block_at_mamba2_shapes(B, T, chunks, heads):
    """The fastest count of the card's sweep at mamba2-1.3b's serving
    prefill (4, 24), its [lm-bf16] prefill (4, 512), (1, 512) and a long
    prefill (1, 4096); (1, 24) and the ragged (1, 4095) by the rule.  T in
    64-row chunks."""
    assert -(-T // 64) == chunks
    assert heads_per_block(B, 64, chunks, H100_SMS) == heads


def _blocks(B, H, chunks, g):
    return B * chunks * -(-H // g)


@pytest.mark.parametrize("sms", [16, 78, 132])
@pytest.mark.parametrize("B", [1, 2, 4, 16])
def test_heads_per_block_fills_one_wave_with_the_fewest_heads(B, sms):
    """A power of two, at most H (or 1): the fewest heads whose output
    blocks fit one wave (two blocks per multiprocessor over several
    chunks, one for a single chunk); the most when no count fits."""
    for H in (1, 3, 24, 64, 80):
        for chunks in (1, 2, 8, 64, 313):
            g = heads_per_block(B, H, chunks, sms)
            wave = sms * (2 if chunks > 1 else 1)
            assert g & (g - 1) == 0 and (g == 1 or g <= H)
            if _blocks(B, H, chunks, g) > wave:
                assert 2 * g > H  # nothing fits: every head in one block
            elif g > 1:
                assert _blocks(B, H, chunks, g // 2) > wave


# ---------------------------------------------------------------------------
# the chunked math over many chunks, against the JAX package
# ---------------------------------------------------------------------------


def _ssd_inputs(B, H, T, P, N, seed, decay):
    """The kernel test's distributions, B and C scaled by 1/sqrt(N); a =
    -|normal| x ``decay``: at 0.002 a 64-row chunk keeps about e^-0.1 of
    the state entering it, so every chunk's output leans on the carry."""
    rng = np.random.default_rng(seed)
    xb = rng.normal(size=(B, H, T, P)).astype(np.float32)
    a = (-np.abs(rng.normal(size=(B, H, T))) * decay).astype(np.float32)
    Bm, Cm = ((rng.normal(size=(B, T, N)) / np.sqrt(N)).astype(np.float32) for _ in range(2))
    return xb, a, Bm, Cm


def _ssd_final_state_ref(xb, a, Bm, Cm):
    """The reference model's final state for the kernel's inputs:
    ``ssd_chunked_ref`` with A = -1, dt = -a and x = xb / dt, in one chunk
    of all T rows (it needs a chunk that divides T: ROADMAP C-ref-5)."""
    dt = jnp.asarray(-a.transpose(0, 2, 1))
    x = jnp.asarray(xb.transpose(0, 2, 1, 3)) / dt[..., None]
    A = -jnp.ones((xb.shape[1],), jnp.float32)
    _, h = jssd.ssd_chunked_ref(x, dt, A, jnp.asarray(Bm), jnp.asarray(Cm), chunk=xb.shape[2])
    return np.asarray(h)


@pytest.mark.parametrize("decay", [0.2, 0.002])
@pytest.mark.parametrize("B,H,T,P,N", [(1, 3, 130, 8, 16), (2, 2, 200, 16, 32), (1, 2, 64, 8, 8)])
def test_ssd_scan_over_many_chunks_matches_jax_oracle(B, H, T, P, N, decay):
    """The wrapper on CPU tensors (128-row chunks) and the plain version at
    the kernel's 64-row chunks, ragged last chunks included."""
    xb, a, Bm, Cm = _ssd_inputs(B, H, T, P, N, seed=T + P, decay=decay)
    y_want = np.asarray(jax_ref.ssd_scan_ref(*map(jnp.asarray, (xb, a, Bm, Cm))))
    h_want = _ssd_final_state_ref(xb, a, Bm, Cm)
    targs = [torch.from_numpy(v) for v in (xb, a, Bm, Cm)]
    before = ssd_scan.launches
    outs = {"wrapper": ssd_scan(*targs), "plain, 64-row chunks": ssd_scan_plain(*targs, chunk=64)}
    for name, (y, h) in outs.items():
        np.testing.assert_allclose(y.numpy(), y_want, atol=2e-4, rtol=2e-4, err_msg=name)
        np.testing.assert_allclose(h.numpy(), h_want, atol=3e-4, rtol=3e-4, err_msg=name)
    assert ssd_scan.launches == before


@pytest.mark.parametrize("T", [65, 300])
def test_rglru_scan_over_many_chunks_matches_jax_oracle(T):
    """Decays in U(0.99, 0.999): a 64-step chunk keeps about 0.6 of the
    state entering it, so the carry shows in every chunk."""
    rng = np.random.default_rng(T)
    a = rng.uniform(0.99, 0.999, (2, T, 24)).astype(np.float32)
    b = rng.normal(size=(2, T, 24)).astype(np.float32)
    want = np.asarray(jax_ref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b)))
    before = rglru_scan.launches
    for fn in (rglru_scan, rglru_scan_plain):
        np.testing.assert_allclose(fn(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want,
                                   atol=1e-4, rtol=1e-4, err_msg=fn.__name__)
    assert rglru_scan.launches == before
