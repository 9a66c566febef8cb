"""``repro_torch.kernels.ops`` against ``repro.kernels.ops``.

Each scheduled wrapper of the port, on CPU tensors (its kernel's plain
version), equals the reference's scheduled wrapper (Pallas interpret mode,
blocks from the v5e DSE) on the same seeded numpy inputs, at shapes that are
not multiples of a tile.  The port schedules on the h100 target; the
table, ``hopper_align`` and the copy of ``core/schedule.py`` are held here
too.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import flash_attention, matmul_requant, moe_gmm, ops, rglru_scan, ssd_scan

SRC = Path(__file__).resolve().parents[1] / "src"


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _mm_operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-10, 10, (M, K)).astype(np.int8)
    w = rng.integers(-10, 10, (K, N)).astype(np.int8)
    mult = rng.integers(1, 8, (N,)).astype(np.int32)
    bias = rng.integers(-1000, 1000, (N,)).astype(np.int32)
    return a, w, mult, bias


@pytest.mark.parametrize("M,K,N", [(48, 80, 112), (3, 37, 11)])
@pytest.mark.parametrize("shift,relu", [(4, False), (5, True)])
def test_scheduled_matmul_requant_floor_matches_reference(M, K, N, shift, relu):
    a, w, mult, bias = _mm_operands(M, K, N, seed=M + K + N)
    want = jax_ops.scheduled_matmul_requant(a, w, mult, bias, shift=shift, relu=relu)
    got = ops.scheduled_matmul_requant(*map(_t, (a, w, mult, bias)), shift=shift, relu=relu).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("relu", [False, True])
def test_scheduled_matmul_requant_even_matches_interpreter_requant(relu):
    """Even mode has no reference oracle (ROADMAP C-ref-4): held against the
    interpreter's requant, clip(round_half_even((acc*M + B) / 2^S)), in
    exact float64."""
    a, w, mult, bias = _mm_operands(48, 80, 112, seed=7)
    shift = 5
    acc = a.astype(np.int64) @ w.astype(np.int64)
    y = np.round((acc * mult + bias).astype(np.float64) / 2.0**shift)
    want = np.clip(np.maximum(y, 0) if relu else y, -128, 127).astype(np.int8)
    got = ops.scheduled_matmul_requant(
        *map(_t, (a, w, mult, bias)), shift=shift, relu=relu, rounding="even"
    ).numpy()
    np.testing.assert_array_equal(got, want)


def _qkv(B, H, KV, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    k = rng.normal(size=(B, KV, Sk, D)).astype(np.float32)
    v = rng.normal(size=(B, KV, Sk, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,H,KV,S,D", [(1, 4, 2, 40, 24), (2, 3, 1, 24, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_scheduled_flash_attention_matches_reference(B, H, KV, S, D, causal):
    q, k, v = _qkv(B, H, KV, S, S, D, seed=S + D)
    want = jax_ops.scheduled_flash_attention(q, k, v, causal=causal)
    got = ops.scheduled_flash_attention(*map(_t, (q, k, v)), causal=causal).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=2e-5)


def test_scheduled_flash_attention_with_fewer_queries_than_keys():
    """Sq < Sk (ROADMAP C-ref-1): with ``q_offset = 0`` the port equals the
    reference's kernel, which masks from 0; with ``q_offset = Sk - Sq`` it
    equals the reference's oracle, which aligns at the end."""
    q, k, v = _qkv(1, 4, 2, 24, 40, 16, seed=3)
    tq, tk, tv = map(_t, (q, k, v))
    kernel = jax_ops.scheduled_flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(
        ops.scheduled_flash_attention(tq, tk, tv, causal=True).numpy(), np.asarray(kernel), atol=2e-5, rtol=2e-5
    )
    oracle = jax_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got = ops.scheduled_flash_attention(tq, tk, tv, causal=True, q_offset=40 - 24).numpy()
    np.testing.assert_allclose(got, np.asarray(oracle), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("E,C,D,F", [(3, 10, 24, 40), (2, 17, 48, 9)])
def test_scheduled_moe_gmm_matches_reference(E, C, D, F):
    rng = np.random.default_rng(E * C)
    x = rng.normal(size=(E, C, D)).astype(np.float32)
    w = rng.normal(size=(E, D, F)).astype(np.float32)
    want = jax_ops.scheduled_moe_gmm(x, w)
    got = ops.scheduled_moe_gmm(_t(x), _t(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,T,W", [(2, 37, 48), (1, 20, 130)])
def test_scheduled_rglru_scan_matches_reference(B, T, W):
    rng = np.random.default_rng(T + W)
    a = rng.uniform(0.2, 0.999, (B, T, W)).astype(np.float32)
    b = rng.normal(size=(B, T, W)).astype(np.float32)
    want = jax_ops.scheduled_rglru_scan(a, b)
    got = ops.scheduled_rglru_scan(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)


def _final_state(xb, a, Bm):
    """h_T of h_t = e^{a_t} h_{t-1} + xb_t B_t^T, in float64."""
    B, H, T, P = xb.shape
    h = np.zeros((B, H, P, Bm.shape[-1]))
    for t in range(T):
        h = np.exp(a[:, :, t])[..., None, None] * h + np.einsum("bhp,bn->bhpn", xb[:, :, t], Bm[:, t])
    return h


@pytest.mark.parametrize("B,H,T,P,N", [(2, 3, 40, 8, 16), (1, 5, 24, 4, 8)])
def test_scheduled_ssd_scan_matches_reference(B, H, T, P, N):
    rng = np.random.default_rng(T + H)
    xb = rng.normal(size=(B, H, T, P)).astype(np.float32)
    a = (-np.abs(rng.normal(size=(B, H, T))) * 0.2).astype(np.float32)
    Bm = rng.normal(size=(B, T, N)).astype(np.float32)
    Cm = rng.normal(size=(B, T, N)).astype(np.float32)
    want = jax_ops.scheduled_ssd_scan(xb, a, Bm, Cm)
    y, h_final = ops.scheduled_ssd_scan(*map(_t, (xb, a, Bm, Cm)))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(h_final.numpy(), _final_state(xb, a, Bm), atol=2e-4, rtol=2e-4)


def test_wrappers_count_no_launch_on_the_cpu():
    kernels = (matmul_requant, flash_attention, moe_gmm, rglru_scan, ssd_scan)
    before = [k.launches for k in kernels]
    a, w, mult, bias = _mm_operands(5, 9, 7, seed=0)
    ops.scheduled_matmul_requant(*map(_t, (a, w, mult, bias)))
    q, k, v = _qkv(1, 2, 1, 8, 8, 8, seed=0)
    ops.scheduled_flash_attention(*map(_t, (q, k, v)))
    ops.scheduled_moe_gmm(torch.ones(2, 3, 4), torch.ones(2, 4, 5))
    ops.scheduled_rglru_scan(torch.ones(1, 6, 4), torch.ones(1, 6, 4))
    ops.scheduled_ssd_scan(torch.ones(1, 2, 6, 3), -torch.ones(1, 2, 6), torch.ones(1, 6, 4), torch.ones(1, 6, 4))
    assert [k.launches for k in kernels] == before


def test_kernel_schedule_table_schedules_on_h100():
    rows = ops.kernel_schedule_table()
    assert len(rows) >= 5
    assert ops._h100().name == "h100"
    modules = {m.name for m in ops._h100().modules}
    assert [r["kernel"] for r in rows[:5]] == [
        "matmul_requant", "matmul_requant", "flash_attention", "moe_gmm", "rglru_scan"
    ]
    for r in rows:
        assert r["predicted_cycles"] > 0
        assert r["module"] in modules
        assert set(r["block"]) <= set(r["dims"])
        for dim, b in r["block"].items():
            assert 1 <= b <= r["dims"][dim] and r["dims"][dim] % b == 0, (r["kernel"], dim, b)
        assert r["module"] == ("cuda_core" if r["kernel"].endswith("_scan") else "tensor_core")
    knobs = {r["kernel"]: r["knob"] for r in rows}
    assert 1 <= knobs["ssd_scan"]["heads_per_block"] <= 64
    assert all(knobs[k] is None for k in knobs if k != "ssd_scan")


@pytest.mark.parametrize("kind,elem_bytes,q", [
    ("row", 2, 16), ("col", 2, 8), ("k", 2, 16), ("k", 1, 32), ("k", 4, 8), ("warp", 4, 32)
])
def test_hopper_align_is_a_quantum_multiple_never_zero_never_past_the_rounded_dim(kind, elem_bytes, q):
    for dim in range(1, 200):
        rounded = -(-dim // q) * q
        for size in range(1, dim + 1):
            got = ops.hopper_align(size, kind, elem_bytes)
            assert got % q == 0 and got >= size and got > 0
            assert got <= rounded
    assert ops.hopper_align(5, "other") == 5
    with pytest.raises(ValueError):
        ops.hopper_align(0, "row")


def test_divisor_clip_matches_reference():
    for dim in range(1, 70):
        for block in range(0, 80):
            assert ops._divisor_clip(block, dim) == jax_ops._divisor_clip(block, dim)


def test_core_schedule_is_the_reference_copy():
    ref = (SRC / "repro" / "core" / "schedule.py").read_text()
    port = (SRC / "repro_torch" / "core" / "schedule.py").read_text()
    assert port == ref.replace("repro.", "repro_torch.")
