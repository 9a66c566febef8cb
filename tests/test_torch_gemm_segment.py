"""The GEMM segment entry on the CPU: ``matmul_requant_f32`` (plain path)
against the JAX package's Pallas ``matmul_requant`` in interpret mode on
the reference lowering's own casts, tolerance 0; the lowering's GEMM route
issuing nothing but views outside the kernel wrapper (one launch per
segment on the card); and DAE and DS-CNN through ``lower`` bit-exact with
the reference interpreter."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_port import io, one_torch_thread, port_compiled, ref_outputs  # noqa: F401
from repro.kernels import matmul_requant as jax_matmul_requant
from repro_torch.backend import compile_aot
from repro_torch.cnn import params_to_torch
from repro_torch.kernels import matmul_requant_f32, matmul_requant_f32_plain

# the module, not the function repro_torch.backend re-exports under its name
lower_mod = importlib.import_module("repro_torch.backend.lower")
GRID = [(m, k, n) for m in (1, 2, 16, 17) for k in (8, 64, 640, 13) for n in (2, 8, 10, 128, 640)]


def _jax_segment(x, w, b, *, shift, relu, rounding):
    """The reference lowering's GEMM route (``repro.backend.lower``): its
    casts around the Pallas kernel, run in interpret mode on the CPU."""
    m, k = x.shape
    n = w.shape[0]
    a8 = jnp.asarray(x, jnp.float32).astype(jnp.int8)
    w8 = jnp.asarray(w).astype(jnp.int8).T
    bias = jnp.asarray(b).astype(jnp.int32) if b is not None else jnp.zeros((n,), jnp.int32)
    y8 = jax_matmul_requant(a8, w8, jnp.ones((n,), jnp.int32), bias, shift=shift, relu=relu, rounding=rounding,
                            block_m=m, block_n=n, block_k=k)
    return np.asarray(y8.astype(jnp.float32))


@pytest.mark.parametrize("M,K,N", GRID)
def test_segment_entry_matches_jax_kernel(M, K, N):
    rng = np.random.default_rng(M * 1000 + K * 10 + N)
    x = rng.integers(-128, 128, (M, K)).astype(np.float32)
    w = rng.integers(-128, 128, (N, K)).astype(np.float32)
    b = rng.integers(-3000, 3000, (N,)).astype(np.float32)
    for rounding in ("floor", "even"):
        for relu in (False, True):
            for bias in (b, None):
                kw = dict(shift=5, relu=relu, rounding=rounding)
                got = matmul_requant_f32(torch.from_numpy(x), torch.from_numpy(w),
                                         None if bias is None else torch.from_numpy(bias), **kw)
                assert got.dtype == torch.float32
                assert np.array_equal(got.numpy(), _jax_segment(x, w, bias, **kw)), kw


def test_segment_entry_rejects_bad_arguments():
    x, w = torch.zeros((2, 8)), torch.zeros((4, 8))
    with pytest.raises(ValueError):
        matmul_requant_f32(x, torch.zeros((4, 9)))
    with pytest.raises(ValueError):
        matmul_requant_f32(x, w, torch.zeros(3))
    with pytest.raises(TypeError):
        matmul_requant_f32(x.to(torch.int32), w)
    with pytest.raises(TypeError):
        matmul_requant_f32(x, w.double())
    with pytest.raises(ValueError):
        matmul_requant_f32(x, w, rounding="up")


def test_segment_entry_refuses_int8_activations_and_truncates_fractions():
    """int8 activations reach the segment entry as float32 (the lowering
    casts a non-float32 graph input first), so the entry refuses them."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-128, 128, (3, 40)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-128, 128, (6, 40)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-500, 500, (6,)).astype(np.float32))
    want = matmul_requant_f32(x, w, b, shift=4, rounding="even")
    with pytest.raises(TypeError):
        matmul_requant_f32(x.to(torch.int8), w, b, shift=4, rounding="even")
    # inside int8 range a fraction truncates toward zero, as Tensor.to(torch.int8)
    frac = x + torch.from_numpy(rng.uniform(-0.99, 0.99, x.shape).astype(np.float32)) * torch.sign(x)
    assert torch.equal(matmul_requant_f32_plain(frac, w, b, shift=4, rounding="even"), want)


class _OpLog(TorchDispatchMode):
    """Every aten op dispatched while the mode is on."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("M", [1, 16])
@pytest.mark.parametrize("net,tgt", [("DAE", "gap9"), ("DAE", "diana"), ("DSCNN", "gap9")])
def test_gemm_route_issues_nothing_but_views_outside_the_kernel(monkeypatch, net, tgt, M, dtype):
    """With the kernel wrapper stubbed, a GEMM segment's executor issues no
    aten op but views: on the card the segment is the one launch.  An int8
    graph input adds its one cast to float32, as the reference casts it."""
    cm = port_compiled(net, tgt)
    params = params_to_torch(io(net)[0], "cpu")
    calls = []

    def stub(x, w, bias=None, **kw):
        calls.append((x, w, bias, kw))
        return out

    monkeypatch.setattr(lower_mod, "matmul_requant_f32", stub)
    segments = [ls for ls in cm.segments if ls.route == "pallas_gemm"]
    assert segments
    for ls in segments:
        sp = ls.params_slice(params)
        n, k = sp[ls.segment.anchor.name]["w"].shape
        x = torch.from_numpy(np.random.default_rng(k).integers(-128, 128, (M, k)).astype(np.float32)).to(dtype)
        out = torch.zeros((M, n))
        calls.clear()
        with _OpLog() as log:
            got = ls.fn(sp, x)
        assert got is out
        casts = [torch.ops.aten._to_copy.default] if dtype != torch.float32 else []
        assert [op for op in log.ops if not op.is_view] == casts, log.ops
        (xa, wa, ba, kw), = calls
        assert xa.dtype == torch.float32 and tuple(xa.shape) == (M, k)
        assert wa is sp[ls.segment.anchor.name]["w"]
        assert ba is None or any(ba is p.get("b") for p in sp.values())
        assert kw["rounding"] == "even"


@pytest.mark.parametrize("memory", [None, "xla", "arena"])
@pytest.mark.parametrize("net,tgt", [("DAE", "gap9"), ("DAE", "diana"), ("DSCNN", "gap9")])
def test_gemm_nets_through_lower_bit_exact_with_reference(net, tgt, memory):
    """``CompiledModel.run`` (``memory=None``) and the AOT executor in each
    memory mode, where a segment's input is an arena view."""
    cm = port_compiled(net, tgt)
    assert cm.routes().get("pallas_gemm", 0) > 0
    params, x = io(net)
    got = cm.run(params, x) if memory is None else compile_aot(cm, memory=memory).run(params, x)
    for k, want in ref_outputs(net).items():
        assert np.array_equal(got[k].numpy(), want), k
