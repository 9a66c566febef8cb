"""Plain torch oracles for the port's kernels (allclose / equality targets).

The port of ``repro.kernels.ref``: one oracle for each of the five
kernels.
"""

from __future__ import annotations

import math

import torch

__all__ = ["matmul_requant_ref", "flash_attention_ref", "moe_gmm_ref", "rglru_scan_ref", "ssd_scan_ref"]


def matmul_requant_ref(a, w, mult, bias, *, shift: int = 8, relu: bool = False):
    """(x*M + B) >> S, clip int8 — the paper's requant arithmetic (floor)."""
    acc = (a.to(torch.int32)[:, :, None] * w.to(torch.int32)[None, :, :]).sum(1, dtype=torch.int32)
    y = acc * mult[None, :].to(torch.int32) + bias[None, :].to(torch.int32)
    y = y >> shift
    if relu:
        y = torch.clamp_min(y, 0)
    return torch.clamp(y, -128, 127).to(torch.int8)


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Direct softmax attention with GQA; fp32 math.  q (B, H, Sq, D),
    k/v (B, KV, Sk, D).  The causal mask is aligned at the end
    (``tril(k=Sk-Sq)``), as the reference oracle's is."""
    B, H, Sq, D = q.shape
    _, KV, Sk, _ = k.shape
    g = H // KV
    qf = q.float().reshape(B, KV, g, Sq, D) / math.sqrt(D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float())
    if causal:
        mask = torch.tril(torch.ones((Sq, Sk), dtype=torch.bool, device=q.device), diagonal=Sk - Sq)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


def moe_gmm_ref(x, w):
    """y[e] = x[e] @ w[e] in fp32, returned in x's dtype.  x (E, C, D), w (E, D, F)."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def rglru_scan_ref(a, b):
    """Sequential scan oracle (fp32): h_t = a_t h_{t-1} + b_t from h_0 = 0.
    a, b (B, T, W) -> h (B, T, W) float32."""
    af, bf = a.float(), b.float()
    h = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32, device=a.device)
    hs = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def ssd_scan_ref(xb, a, Bm, Cm):
    """Sequential state-space oracle: h_t = e^{a_t} h_{t-1} + xb_t B_t^T,
    y_t = h_t C_t.  xb (B, H, T, P), a (B, H, T), Bm/Cm (B, T, N) ->
    y (B, H, T, P) float32."""
    B, H, T, P = xb.shape
    N = Bm.shape[-1]
    xf, af, bf, cf = xb.float(), a.float(), Bm.float(), Cm.float()
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xb.device)
    ys = []
    for t in range(T):
        h = torch.exp(af[:, :, t])[..., None, None] * h + torch.einsum("bhp,bn->bhpn", xf[:, :, t], bf[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, cf[:, t]))
    return torch.stack(ys, dim=2)
