"""Blocked GQA flash attention with an online softmax — the Hopper kernel.

Port of the Pallas TPU kernel ``repro.kernels.flash_attention``
(``_kernel``), generalised to what the reference model's
``repro.models.attention._chunked_attention`` computes: the Pallas kernel
is that function with ``q_offset = 0`` and ``window = None``.

* q ``(B, H, Sq, D)``, k/v ``(B, KV, Sk, D)``, f32 or bf16; the output is
  ``(B, H, Sq, D)`` in q's dtype.  ``scale = 1/sqrt(D)``, applied to q in
  fp32 before the product; running max, sum and accumulator in fp32.
* GQA: query head ``h`` reads KV head ``h // (H // KV)``.
* Query ``i`` sits at position ``q_offset + i``.  A key ``j`` is kept
  where ``q_pos >= j`` (``causal``) and ``q_pos - j < window`` (a window
  is given); masked scores are ``-1e30`` (not ``-inf``), as in both
  references, and the result is divided by ``max(l, 1e-30)``.  With
  ``q_offset = Sk - Sq`` the causal mask is the oracle's end-aligned
  ``tril(k=Sk-Sq)`` (``ref.flash_attention_ref``).

On a CUDA tensor :func:`flash_attention` launches the hand-written CUDA
kernel in ``csrc/flash_attention.cu`` (built for ``sm_90a`` at first use,
see :mod:`repro_torch.kernels._build`); on a CPU tensor it computes
:func:`flash_attention_plain`, the reference's chunked online softmax in
plain torch.  There is no fallback between the two: a CUDA call launches
or raises.

The kernel replaces ``src/repro/kernels/flash_attention.py::_kernel``.
It is bound by bytes (and launch latency) at the serving engine's short
prompts and by tensor-core flops at long prefill.  bf16 runs an FA2-style
tensor-core kernel (``mma.sync`` on bf16, ``cp.async`` K/V pipeline); f32
runs a CUDA-core kernel, since TF32 would miss the 2e-5 tolerance.  The
source says what each design does and what it leaves for later.  It takes
any Sq, Sk >= 1 and D <= 256 (the Pallas kernel asserts exact tiling), and
reads every operand through its strides, so the model passes its
``(B, S, H, D)`` activations as ``(B, H, S, D)`` views without a copy.
bf16 operands whose rows start on 16 bytes are staged by 16-byte copies,
others by element loads, in the same kernel.  The output has q's memory
layout.

Training: under grad, with an input that needs a gradient, a CUDA call
goes through ``_FlashAttention`` (an ``autograd.Function``: the same
counted launch forward) whose backward is :func:`flash_attention_backward`,
the adjoint in torch ops (P recomputed with the kernel's mask, dQ, dK,
dV); the reference has no backward kernel either.  A CUDA output under
grad never lacks a grad_fn.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch._device import upcast

from . import _build, _layout

__all__ = ["flash_attention", "flash_attention_backward", "flash_attention_plain"]

_MASKED = -1e30
_CHUNK = 1024  # the reference model's kv_chunk
_MAX_D = 256
_INT_MAX = 2**31 - 1
_BACKWARD_SCORES = 1 << 25  # fp32 scores of one backward chunk of query rows (128 MB)


def _check_args(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"need 4-d q, k, v, got {q.dim()}, {k.dim()}, {v.dim()} dims")
    B, H, _, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(
            f"need q (B, H, Sq, D) and k, v (B, KV, Sk, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.shape[1] == 0 or H % k.shape[1] != 0:
        raise ValueError(f"H={H} is not a multiple of KV={k.shape[1]}")


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    window: int | None = None,
) -> torch.Tensor:
    """The kernel's function in plain torch, on any device: the
    reference's ``_chunked_attention`` (online softmax over key chunks of
    1024, fp32 accumulators), in the (B, H, S, D) layout, with a ragged
    last chunk allowed."""
    _check_args(q, k, v)
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(D)
    qf = (upcast(q) * scale).reshape(B, KV, g, Sq, D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((B, KV, g, Sq), -math.inf, dtype=qf.dtype, device=q.device)
    l = torch.zeros((B, KV, g, Sq), dtype=qf.dtype, device=q.device)
    acc = torch.zeros((B, KV, g, Sq, D), dtype=qf.dtype, device=q.device)
    for c0 in range(0, Sk, _CHUNK):
        kb = upcast(k[:, :, c0 : c0 + _CHUNK])
        vb = upcast(v[:, :, c0 : c0 + _CHUNK])
        k_pos = torch.arange(c0, c0 + kb.shape[2], device=q.device)
        s = torch.einsum("bkgqd,bkcd->bkgqc", qf, kb)
        mask = torch.ones((Sq, kb.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        s = torch.where(mask, s, torch.full_like(s, _MASKED))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqc,bkcd->bkgqd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, H, Sq, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, *([ll] * 12), i, i, i, i, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(
    q: torch.Tensor,  # (B, H, Sq, D)
    k: torch.Tensor,  # (B, KV, Sk, D)
    v: torch.Tensor,  # (B, KV, Sk, D)
    *,
    causal: bool = True,
    q_offset: int = 0,
    window: int | None = None,
) -> torch.Tensor:
    """Attention ``(B, H, Sq, D)`` in q's dtype.

    CUDA tensors launch the Hopper kernel (counted in
    ``flash_attention.launches``); CPU tensors take
    :func:`flash_attention_plain`.  Under grad, with an input that needs a
    gradient, CUDA tensors go through :class:`_FlashAttention`: the same
    launch forward, :func:`flash_attention_backward` backward.
    """
    q_offset = int(q_offset)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, q_offset, window)
    _check_args(q, k, v)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash_attention needs q, k, v on one CUDA device, got "
            f"{[str(t.device) for t in (q, k, v)]}"
        )
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if not 1 <= D <= _MAX_D:
        raise ValueError(f"head dim D={D} outside 1..{_MAX_D}")
    if H > 65535 or B > 65535:
        raise ValueError(f"B={B}, H={H}: each must be <= 65535 (grid limits)")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need unit stride along D")
    if not -_INT_MAX <= q_offset <= _INT_MAX - Sq:
        raise ValueError(f"q_offset={q_offset} out of int32 range")
    if Sk == 0:
        raise ValueError("flash_attention needs at least one key (Sk >= 1)")
    out = torch.empty_like(q)  # q's layout: a (B, S, H, D) view stays one
    if out.numel() == 0:
        return out
    has_window = window is not None
    win = max(-_INT_MAX, min(int(window), _INT_MAX)) if has_window else 0
    bf16 = q.dtype == torch.bfloat16
    with torch.cuda.device(q.device):
        err = _launcher()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(bf16), int(bf16 and _layout.rows_16b_aligned(q, k, v, out)), B, H, KV, Sq, Sk, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            int(bool(causal)), q_offset, int(has_window), win,
            1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The adjoint of :func:`flash_attention`: ``dout`` (B, H, Sq, D) ->
    (dq, dk, dv) in q's, k's and v's dtypes, in plain torch ops on any
    device (no backward kernel: the reference has none either).

    Per chunk of query rows (so that the fp32 (B, H, rows, Sk) scores stay
    near 128 MB), in fp32: the probabilities P are recomputed with the
    kernel's own mask (``causal`` from ``q_offset``, ``window``, masked
    scores -1e30, so a row with no valid key attends uniformly, as the
    kernel's does); dP = dO·Vᵀ; dS = P∘(dP − D) with D = rowsum(P∘dP),
    which is rowsum(dO∘O) for the exact O, and 0 at masked scores; dQ = dS·K·scale, dK = dSᵀ·Q·scale,
    dV = Pᵀ·dO, each query head's dK and dV summed into its GQA group's K/V
    head.  Counted in ``flash_attention_backward.calls``."""
    _check_args(q, k, v)
    flash_attention_backward.calls += 1
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(D)
    qs = (q.float() * scale).reshape(B, KV, g, Sq, D)
    do = dout.float().reshape(B, KV, g, Sq, D)
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(qs)
    dk = torch.zeros((B, KV, Sk, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    k_pos = torch.arange(Sk, device=q.device)
    rows = max(1, _BACKWARD_SCORES // max(B * H * Sk, 1))
    for r0 in range(0, Sq, rows):
        qc, doc = qs[:, :, :, r0 : r0 + rows], do[:, :, :, r0 : r0 + rows]
        q_pos = q_offset + torch.arange(r0, r0 + qc.shape[3], device=q.device)
        s = torch.einsum("bkgqd,bkcd->bkgqc", qc, kf)
        mask = torch.ones((qc.shape[3], Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        p = torch.softmax(torch.where(mask, s, torch.full_like(s, _MASKED)), dim=-1)
        dp = torch.einsum("bkgqd,bkcd->bkgqc", doc, vf)
        # a masked score is a constant: no gradient (a row with no valid key
        # attends uniformly, and its P would pass one on)
        ds = torch.where(mask, p * (dp - (p * dp).sum(dim=-1, keepdim=True)), 0.0)
        dq[:, :, :, r0 : r0 + rows] = torch.einsum("bkgqc,bkcd->bkgqd", ds, kf) * scale
        dk += torch.einsum("bkgqc,bkgqd->bkcd", ds, qc)
        dv += torch.einsum("bkgqc,bkgqd->bkcd", p, doc)
    return dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


flash_attention_backward.calls = 0


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward (counted, unchanged) under autograd, with
    :func:`flash_attention_backward` as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, window):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, q_offset, window)
        return flash_attention(q, k, v, causal=causal, q_offset=q_offset, window=window)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        causal, q_offset, window = ctx.mask
        dq, dk, dv = flash_attention_backward(q, k, v, dout, causal=causal, q_offset=q_offset, window=window)
        return dq, dk, dv, None, None, None
