"""Mamba-2 SSD chunk scan with a carried state — the Hopper kernel.

Port of the Pallas TPU kernel ``repro.kernels.ssd_scan`` (``_kernel``):
the state-space recurrence ``h_t = e^{a_t} h_{t-1} + xb_t B_t^T``,
``y_t = h_t C_t`` per (batch, head), computed chunk by chunk in its dual
form with the ``(P, N)`` state carried across chunks.

* xb ``(B, H, T, P)`` (x pre-scaled by dt) and a ``(B, H, T)`` (dt * A,
  <= 0) in float32; Bm, Cm ``(B, T, N)`` in float32 or bfloat16.
* Returns ``(y (B, H, T, P), h_final (B, H, P, N))``, both float32.  The
  final state is the one addition to the Pallas kernel's signature: the
  reference model's ``ssd_chunked_ref`` returns it, and prefill writes it
  to the cache.

On a CUDA tensor :func:`ssd_scan` launches the hand-written CUDA kernel
in ``csrc/ssd_scan.cu`` (built for ``sm_90a`` at first use, see
:mod:`repro_torch.kernels._build`); on a CPU tensor it computes
:func:`ssd_scan_plain`, the reference model's chunked algorithm
(``repro.models.ssd.ssd_chunked_ref``) in plain torch.  There is no
fallback between the two: a CUDA call launches or raises.

The kernel replaces ``src/repro/kernels/ssd_scan.py::_kernel``.  It is
bound by its fp32 flops at long prompts.  One counted call issues two or
three kernels, each parallel over time chunks: the chunks' own states, a
carry of the state across chunks (skipped when T fits one chunk), and the
outputs, with the chunk products register-tiled in fp32 on the CUDA cores
— the source says how long a chunk is, what bounds each kernel and why;
the outputs' blocks share C . B^T among :func:`heads_per_block` heads.
It takes any T (the Pallas kernel asserts exact tiling) and reads every
operand through its strides, so the model passes its ``(B, T, H, P)``
activations as ``(B, H, T, P)`` views without a copy.  y takes xb's
memory layout.

Training: under grad, with an input that needs a gradient, a CUDA call
goes through ``_SsdScan`` (an ``autograd.Function``: the same counted
launch forward) whose backward is :func:`ssd_scan_backward`, the chunked
algorithm's adjoint in explicit torch ops (the reference has no backward
kernel either).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch._device import upcast

from . import _build

__all__ = ["heads_per_block", "ssd_scan", "ssd_scan_backward", "ssd_scan_plain"]

_SMEM_MAX = 232448  # shared memory one block may use on an H100 (227 KB)
_GRID_Y_MAX = 65535


def heads_per_block(B: int, H: int, chunks: int, sms: int) -> int:
    """Heads that share one output block's C . B^T (which has no head index)
    in a call of batch B, H heads and ``chunks`` time chunks, on a card of
    ``sms`` multiprocessors: the fewest, a power of two, whose
    ``B * chunks * ceil(H / G)`` blocks fit one wave — two blocks per
    multiprocessor (the output kernel's occupancy) when there are several
    chunks, one for a single chunk, where no carried state is read out and
    C . B^T is about four times a head's own work, so that sharing it wins
    over occupancy.  When no count fits, the most heads up to H.  On the
    H100 (132 SMs) this picks the fastest count of ``chip_smoke.py``'s
    sweep at mamba2-1.3b's (4, 24), (1, 512), (4, 512) and (1, 4096)."""
    wave = sms * (2 if chunks > 1 else 1)
    g = 1
    while 2 * g <= H and B * chunks * -(-H // g) > wave:
        g *= 2
    return g


def _check_args(xb, a, Bm, Cm) -> None:
    if xb.dim() != 4 or a.dim() != 3 or Bm.dim() != 3 or Cm.dim() != 3:
        raise ValueError("need xb (B, H, T, P), a (B, H, T), Bm and Cm (B, T, N)")
    B, H, T, _ = xb.shape
    if tuple(a.shape) != (B, H, T) or Bm.shape != Cm.shape or tuple(Bm.shape[:2]) != (B, T):
        raise ValueError(
            f"need xb (B, H, T, P), a (B, H, T), Bm and Cm (B, T, N), got {tuple(xb.shape)}, "
            f"{tuple(a.shape)}, {tuple(Bm.shape)}, {tuple(Cm.shape)}"
        )


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L) with out[i,j] = sum_{j<k<=i} x[k], -inf above the diagonal."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, -torch.inf)


def ssd_scan_plain(
    xb: torch.Tensor,  # (B, H, T, P)
    a: torch.Tensor,  # (B, H, T)
    Bm: torch.Tensor,  # (B, T, N)
    Cm: torch.Tensor,  # (B, T, N)
    *,
    chunk: int = 128,
    init_state: torch.Tensor | None = None,  # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch, on any device: the reference
    model's chunked SSD (intra-chunk quadratic term, chunk-final states,
    inter-chunk recurrence, state contribution), in fp32, in the kernel's
    (B, H, T, P) layout.  A ragged last chunk is padded with zeros and
    ``a = 0``, which changes neither y nor the final state.  Returns
    ``(y (B, H, T, P), final_state (B, H, P, N))``."""
    _check_args(xb, a, Bm, Cm)
    Bsz, H, T, P = xb.shape
    N = Bm.shape[-1]
    L = max(1, min(chunk, T))
    pad = (-T) % L
    nc = (T + pad) // L
    xf = torch.nn.functional.pad(upcast(xb), (0, 0, 0, pad)).reshape(Bsz, H, nc, L, P)
    af = torch.nn.functional.pad(upcast(a), (0, pad)).reshape(Bsz, H, nc, L)
    Bc = torch.nn.functional.pad(upcast(Bm), (0, 0, 0, pad)).reshape(Bsz, nc, L, N)
    Cc = torch.nn.functional.pad(upcast(Cm), (0, 0, 0, pad)).reshape(Bsz, nc, L, N)

    a_cs = torch.cumsum(af, dim=-1)  # (B, H, c, l)
    Lmat = torch.exp(_segsum(af))  # (B, H, c, l, l)

    # 1) intra-chunk (diagonal blocks)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y_diag = torch.einsum("bcls,bhcls,bhcsp->bhclp", scores, Lmat, xf)

    # 2) chunk-final states
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)  # (B, H, c, l)
    states = torch.einsum("bcln,bhcl,bhclp->bhcpn", Bc, decay_states, xf)

    # 3) inter-chunk recurrence over chunk states
    if init_state is None:
        init_state = torch.zeros_like(states[:, :, 0])
    states = torch.cat([upcast(init_state)[:, :, None], states], dim=2)  # (B, H, c+1, P, N)
    chunk_decay = torch.nn.functional.pad(a_cs[..., -1], (1, 0))  # (B, H, c+1)
    dc = torch.exp(_segsum(chunk_decay))  # (B, H, c+1, c+1)
    new_states = torch.einsum("bhzc,bhcpn->bhzpn", dc, states)
    prev_states, final_state = new_states[:, :, :-1], new_states[:, :, -1]

    # 4) inter-chunk contribution to outputs
    y_off = torch.einsum("bcln,bhcpn,bhcl->bhclp", Cc, prev_states, torch.exp(a_cs))

    y = (y_diag + y_off).reshape(Bsz, H, nc * L, P)[:, :, :T]
    return y, final_state


def _rev_cumsum(x: torch.Tensor) -> torch.Tensor:
    """The adjoint of ``cumsum`` over the last axis: suffix sums."""
    return x.flip(-1).cumsum(-1).flip(-1)


def _segsum_adjoint(dseg: torch.Tensor) -> torch.Tensor:
    """The adjoint of :func:`_segsum` (through ``cs[i] - cs[j]`` and the
    cumsum under it), given the gradient of its lower triangle."""
    return _rev_cumsum(dseg.sum(-1) - dseg.sum(-2))


def ssd_scan_backward(
    xb: torch.Tensor,  # (B, H, T, P)
    a: torch.Tensor,  # (B, H, T)
    Bm: torch.Tensor,  # (B, T, N)
    Cm: torch.Tensor,  # (B, T, N)
    dy: torch.Tensor | None,  # (B, H, T, P)
    dh_final: torch.Tensor | None = None,  # (B, H, P, N)
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The adjoint of :func:`ssd_scan`: (dy, dh_final; either may be None)
    -> (dxb, da, dBm, dCm), each in its input's dtype, in explicit chunked
    torch ops on any device (no backward kernel: the reference has none).

    It recomputes the forward's chunked quantities (:func:`ssd_scan_plain`'s
    four stages, chunks of ``chunk``, a ragged last chunk padded with zeros
    and ``a = 0``) and transposes each stage in turn, in fp32:

    4. the state term ``E∘(C·Sᵀ)``, E = exp(a_cs): into dC, the states S
       entering each chunk, and a_cs through E;
    3. the inter-chunk recurrence ``S = exp(segsum(chunk decays)) · states``:
       its transpose carries dS (and ``dh_final`` as the last state's) back
       to each chunk's own state, and its decay matrix gives each chunk's
       total decay a gradient, through the segment sums' cumsum;
    2. the chunk-final states ``Bᵀ·(decay∘xb)``: into dB, dxb and a_cs
       (the decay is exp(a_cs[-1] − a_cs));
    1. the intra-chunk term ``(C·Bᵀ ∘ exp(segsum(a)))·xb``: into dxb, dC,
       dB and a_cs through every exp(segsum) entry;

    then da = the suffix sums of da_cs (a_cs is a cumsum within a chunk).
    Counted in ``ssd_scan_backward.calls``."""
    _check_args(xb, a, Bm, Cm)
    ssd_scan_backward.calls += 1
    Bsz, H, T, P = xb.shape
    N = Bm.shape[-1]
    L = max(1, min(chunk, T))
    pad = (-T) % L
    nc = (T + pad) // L
    pad_t = torch.nn.functional.pad
    xf = pad_t(xb.float(), (0, 0, 0, pad)).reshape(Bsz, H, nc, L, P)
    af = pad_t(a.float(), (0, pad)).reshape(Bsz, H, nc, L)
    Bc = pad_t(Bm.float(), (0, 0, 0, pad)).reshape(Bsz, nc, L, N)
    Cc = pad_t(Cm.float(), (0, 0, 0, pad)).reshape(Bsz, nc, L, N)
    if dy is None:
        dyf = torch.zeros_like(xf)
    else:
        dyf = pad_t(dy.float(), (0, 0, 0, pad)).reshape(Bsz, H, nc, L, P)

    # the forward's quantities
    a_cs = torch.cumsum(af, dim=-1)  # (B, H, c, l)
    Lmat = torch.exp(_segsum(af))  # (B, H, c, l, s)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)
    states = torch.einsum("bcln,bhclp->bhcpn", Bc, xf * decay_states[..., None])
    states_full = torch.cat([torch.zeros_like(states[:, :, :1]), states], dim=2)  # (B, H, c+1, P, N)
    dc = torch.exp(_segsum(torch.nn.functional.pad(a_cs[..., -1], (1, 0))))  # (B, H, c+1, c+1)
    prev = torch.einsum("bhzc,bhcpn->bhzpn", dc, states_full)[:, :, :-1]
    E = torch.exp(a_cs)

    # 4) the state term y_off = E * (C . prev^T)
    dyE = dyf * E[..., None]
    dCc = torch.einsum("bhclp,bhcpn->bcln", dyE, prev)
    dprev = torch.einsum("bhclp,bcln->bhcpn", dyE, Cc)
    da_cs = torch.einsum("bhclp,bhclp->bhcl", dyE, torch.einsum("bcln,bhcpn->bhclp", Cc, prev))

    # 3) the inter-chunk recurrence over chunk states
    dfinal = torch.zeros_like(states[:, :, 0]) if dh_final is None else dh_final.float()
    dnew = torch.cat([dprev, dfinal[:, :, None]], dim=2)  # (B, H, c+1, P, N)
    dstates = torch.einsum("bhzc,bhzpn->bhcpn", dc, dnew)[:, :, 1:]
    dchunk = _segsum_adjoint(torch.einsum("bhzpn,bhcpn->bhzc", dnew, states_full) * dc)
    da_cs[..., -1] += dchunk[..., 1:]

    # 2) the chunk-final states, Bᵀ (decay * xb)
    dBc = torch.einsum("bhcpn,bhclp->bcln", dstates, xf * decay_states[..., None])
    dxs = torch.einsum("bhcpn,bcln->bhclp", dstates, Bc)  # the gradient of decay * xb
    dxf = dxs * decay_states[..., None]
    dds = (dxs * xf).sum(-1) * decay_states
    da_cs -= dds
    da_cs[..., -1] += dds.sum(-1)

    # 1) the intra-chunk term, (scores * Lmat) . xb
    M = scores[:, None] * Lmat
    dM = torch.einsum("bhclp,bhcsp->bhcls", dyf, xf)
    dxf += torch.einsum("bhcls,bhclp->bhcsp", M, dyf)
    dseg = dM * M
    da_cs += dseg.sum(-1) - dseg.sum(-2)
    dscores = (dM * Lmat).sum(1)
    dCc += torch.einsum("bcls,bcsn->bcln", dscores, Bc)
    dBc += torch.einsum("bcls,bcln->bcsn", dscores, Cc)

    daf = _rev_cumsum(da_cs)
    return (
        dxf.reshape(Bsz, H, nc * L, P)[:, :, :T].to(xb.dtype),
        daf.reshape(Bsz, H, nc * L)[:, :, :T].to(a.dtype),
        dBc.reshape(Bsz, nc * L, N)[:, :T].to(Bm.dtype),
        dCc.reshape(Bsz, nc * L, N)[:, :T].to(Cm.dtype),
    )


ssd_scan_backward.calls = 0


class _SsdScan(torch.autograd.Function):
    """The kernel's forward (counted, unchanged) under autograd, with
    :func:`ssd_scan_backward` as its backward; a gradient of ``h_final``
    may be absent (None)."""

    @staticmethod
    def forward(ctx, xb, a, Bm, Cm, heads=None):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xb, a, Bm, Cm)
        return ssd_scan(xb, a, Bm, Cm, heads=heads)

    @staticmethod
    def backward(ctx, dy, dh_final):
        return *ssd_scan_backward(*ctx.saved_tensors, dy, dh_final), None


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("ssd_scan")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, *([ll] * 17), p]
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_smem_bytes.argtypes = [i, i]
    lib.ssd_scan_smem_bytes.restype = ll
    lib.ssd_scan_chunks.argtypes = [i]
    lib.ssd_scan_chunks.restype = i
    lib.ssd_scan_scratch_floats.argtypes = [i, i, i, i, i]
    lib.ssd_scan_scratch_floats.restype = ll
    return lib


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ssd_scan(
    xb: torch.Tensor,  # (B, H, T, P)
    a: torch.Tensor,  # (B, H, T)
    Bm: torch.Tensor,  # (B, T, N)
    Cm: torch.Tensor,  # (B, T, N)
    *,
    heads: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y (B, H, T, P), h_final (B, H, P, N))``, both float32.

    CUDA tensors launch the Hopper kernels (two or three, counted once in
    ``ssd_scan.launches``), with ``heads`` heads per output block (1..H;
    ``None``: :func:`heads_per_block`'s rule); CPU tensors take
    :func:`ssd_scan_plain`.  Under grad, with an input that needs a
    gradient, CUDA tensors go through :class:`_SsdScan`: the same launch
    forward, :func:`ssd_scan_backward` backward.
    """
    if xb.device.type == "cpu":
        return ssd_scan_plain(xb, a, Bm, Cm)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xb, a, Bm, Cm)):
        return _SsdScan.apply(xb, a, Bm, Cm, heads)
    _check_args(xb, a, Bm, Cm)
    if xb.device.type != "cuda" or any(t.device != xb.device for t in (a, Bm, Cm)):
        raise ValueError(
            f"ssd_scan needs xb, a, Bm, Cm on one CUDA device, got {[str(t.device) for t in (xb, a, Bm, Cm)]}"
        )
    if xb.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"xb and a must be float32, got {xb.dtype}, {a.dtype}")
    if Bm.dtype not in (torch.float32, torch.bfloat16) or Cm.dtype != Bm.dtype:
        raise TypeError(f"Bm and Cm must both be float32 or both bfloat16, got {Bm.dtype}, {Cm.dtype}")
    B, H, T, P = xb.shape
    if B > _GRID_Y_MAX or H > _GRID_Y_MAX:
        raise ValueError(f"B={B} and H={H} must be <= {_GRID_Y_MAX} (grid limit)")
    if heads is None:
        heads = heads_per_block(B, H, _lib().ssd_scan_chunks(T), _sms(xb.device))
    elif not 1 <= heads <= max(H, 1):
        raise ValueError(f"heads={heads} per block outside 1..H={H}")
    return _launch(xb, a, Bm, Cm, int(heads))


def _launch(xb, a, Bm, Cm, heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`ssd_scan` on checked CUDA operands, with ``heads`` heads per
    output block (the timing script also calls it with other counts)."""
    B, H, T, P = xb.shape
    N = Bm.shape[-1]
    y = torch.empty_like(xb)  # xb's layout: a (B, T, H, P) view stays one
    h_final = torch.empty((B, H, P, N), dtype=torch.float32, device=xb.device)
    if B == 0 or H == 0 or T == 0 or P == 0 or N == 0:
        h_final.zero_()
        return y, h_final
    lib = _lib()
    smem = lib.ssd_scan_smem_bytes(P, N)
    if smem > _SMEM_MAX:
        raise ValueError(f"P={P}, N={N} need {smem} bytes of shared memory per block, over {_SMEM_MAX}")
    floats = lib.ssd_scan_scratch_floats(B, H, T, P, N)
    scratch = torch.empty(floats, dtype=torch.float32, device=xb.device) if floats else None
    with torch.cuda.device(xb.device):
        err = lib.ssd_scan_launch(
            xb.data_ptr(), a.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(), h_final.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            int(Bm.dtype == torch.bfloat16), B, H, T, P, N, heads,
            *xb.stride(), *a.stride(), *Bm.stride(), *Cm.stride(), *y.stride(),
            torch.cuda.current_stream(xb.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return y, h_final


ssd_scan.launches = 0
