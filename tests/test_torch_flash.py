"""The port's flash attention on the CPU against the JAX package.

``flash_attention_plain`` and the ``flash_attention`` wrapper given CPU
tensors are held against the Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) on that file's grid, against the
reference model's ``_chunked_attention`` with ``q_offset`` and a sliding
window, against the oracle ``ref.flash_attention_ref`` for Sq != Sk
(``q_offset = Sk - Sq``: the oracle aligns its causal mask at the end),
and on ragged lengths the Pallas kernel cannot tile.  Inputs are made
with numpy from a seed and handed to both packages; bf16 inputs are
rounded from the same float32 values on both sides.  Tolerances are the
reference's: 2e-5 for f32 and 2e-2 for bf16 (``test_kernels.py:33``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash
from repro.kernels import ref as jax_ref
from repro.models.attention import _chunked_attention
from repro_torch.kernels import flash_attention, flash_attention_plain
from repro_torch.kernels import ref as port_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRID = [(1, 4, 4, 64, 32), (2, 8, 2, 128, 64), (1, 6, 1, 96, 16)]


def _inputs(seed, q_shape, kv_shape, dtype):
    """Float32 numpy q, k, v and both packages' copies in ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in (q_shape, kv_shape, kv_shape)]
    jx = [jnp.asarray(a, jnp.dtype(dtype)) for a in arrs]
    pt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, pt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _both(q, k, v, **kw):
    """The plain version and the wrapper on CPU tensors (no launch)."""
    before = flash_attention.launches
    outs = {"plain": flash_attention_plain(q, k, v, **kw), "wrapper": flash_attention(q, k, v, **kw)}
    assert flash_attention.launches == before
    return outs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KV,S,D", GRID)
def test_matches_pallas_kernel_on_grid(B, H, KV, S, D, causal, dtype):
    (jq, jk, jv), (q, k, v) = _inputs(S * D + B, (B, H, S, D), (B, KV, S, D), dtype)
    want = _np(jax_flash(jq, jk, jv, causal=causal, block_q=32, block_k=32))
    for name, got in _both(q, k, v, causal=causal).items():
        assert got.dtype == q.dtype and got.shape == q.shape, name
        np.testing.assert_allclose(_np(got), want, atol=TOL[dtype], rtol=TOL[dtype], err_msg=name)


@pytest.mark.parametrize(
    "Sq,Sk,q_offset,causal,window",
    [
        (16, 64, 48, True, None),  # a chunk of queries at the end of the keys
        (64, 64, 0, True, 16),  # sliding window
        (32, 64, 32, True, 8),  # both
        (64, 64, 0, False, 24),  # window without causality
        (8, 32, 100, True, 4),  # rows past the keys: no valid key at all
    ],
)
def test_matches_chunked_attention_with_offset_and_window(Sq, Sk, q_offset, causal, window):
    B, H, KV, D = 2, 4, 2, 32
    (jq, jk, jv), (q, k, v) = _inputs(Sq + Sk + q_offset, (B, Sq, H, D), (B, Sk, KV, D), "float32")
    want = _chunked_attention(jq, jk, jv, causal=causal, q_offset=q_offset, window=window, chunk=16)
    want = _np(want).transpose(0, 2, 1, 3)
    # the model hands over (B, S, H, D) activations as (B, H, S, D) views
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    for name, got in _both(qt, kt, vt, causal=causal, q_offset=q_offset, window=window).items():
        np.testing.assert_allclose(_np(got), want, atol=2e-5, rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk", [(16, 64), (1, 40), (24, 24)])
def test_matches_oracle_with_end_aligned_offset(Sq, Sk, dtype):
    B, H, KV, D = 1, 4, 2, 16
    (jq, jk, jv), (q, k, v) = _inputs(Sq * Sk, (B, H, Sq, D), (B, KV, Sk, D), dtype)
    want = _np(jax_ref.flash_attention_ref(jq, jk, jv, causal=True))
    np.testing.assert_allclose(
        _np(port_ref.flash_attention_ref(q, k, v, causal=True)), want, atol=TOL[dtype], rtol=TOL[dtype]
    )
    for name, got in _both(q, k, v, causal=True, q_offset=Sk - Sq).items():
        np.testing.assert_allclose(_np(got), want, atol=TOL[dtype], rtol=TOL[dtype], err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [5, 24, 37])
def test_ragged_lengths(S, causal):
    B, H, KV, D = 2, 4, 1, 24
    (jq, jk, jv), (q, k, v) = _inputs(S, (B, S, H, D), (B, S, KV, D), "float32")
    want = _np(_chunked_attention(jq, jk, jv, causal=causal, chunk=S)).transpose(0, 2, 1, 3)
    for name, got in _both(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal).items():
        np.testing.assert_allclose(_np(got), want, atol=2e-5, rtol=2e-5, err_msg=name)


def test_ragged_last_chunk_matches_chunked_attention():
    """Sk = 1100: a full 1024-key chunk and a ragged one, against the
    reference at one chunk of all the keys (only the summation order
    differs)."""
    (jq, jk, jv), (q, k, v) = _inputs(3, (1, 8, 2, 16), (1, 1100, 1, 16), "float32")
    want = _chunked_attention(jq, jk, jv, causal=True, q_offset=1092, chunk=1100)
    want = _np(want).transpose(0, 2, 1, 3)
    for name, got in _both(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True, q_offset=1092).items():
        np.testing.assert_allclose(_np(got), want, atol=2e-5, rtol=2e-5, err_msg=name)


@pytest.mark.parametrize(
    "shapes",
    [((1, 3, 8, 16), (1, 2, 8, 16)), ((1, 4, 8, 16), (1, 2, 8, 8)), ((1, 4, 8, 16), (2, 2, 8, 16))],
)
def test_rejects_mismatched_shapes(shapes):
    q = torch.zeros(shapes[0])
    k = torch.zeros(shapes[1])
    with pytest.raises(ValueError):
        flash_attention(q, k, k)
