"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060) — in PyTorch.

The port of ``repro.models.ssd``.  Block layout follows mamba2: in_proj
-> (z | x | B | C | dt), causal depthwise conv on (x, B, C) (with a
per-channel bias where ``cfg.ssm_conv_bias``, as granite-4.0-h's), SSD
core, gated RMSNorm, out_proj.

* :func:`ssd_block` computes its SSD core through
  :func:`repro_torch.kernels.ssd_scan` (the hand-written CUDA kernel on the
  card, the chunked algorithm on the CPU), where the reference calls its
  plain :func:`ssd_chunked_ref`; both return the final state, which
  ``return_state=True`` hands to the cache.  The reference's
  ``assert T % chunk == 0`` with ``chunk = min(128, T)`` is kept, so a
  prompt the reference refuses (200 tokens, say) fails here alike
  (ROADMAP C-ref-5); the kernel itself takes any T.
* :func:`ssd_decode_step` is one O(1) state update in plain torch, as the
  reference's is plain jnp.

The port does not shard: the reference's ``constrain`` calls are dropped.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch._device import upcast
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec, rmsnorm, torch_dtype
from repro_torch.models.rglru import _causal_conv1d

__all__ = ["ssd_params", "ssd_block", "ssd_decode_step", "ssd_chunked_ref", "ssd_state_init"]


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    return d_in, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def ssd_params(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_in, H, P, N = _dims(cfg)
    cw = cfg.ssm_conv
    p = {
        "in_z": ParamSpec((d, d_in), ("embed", "ffn"), cfg.dtype),
        "in_x": ParamSpec((d, d_in), ("embed", "ffn"), cfg.dtype),
        "in_B": ParamSpec((d, N), ("embed", None), cfg.dtype),
        "in_C": ParamSpec((d, N), ("embed", None), cfg.dtype),
        "in_dt": ParamSpec((d, H), ("embed", "heads"), cfg.dtype, scale=0.1),
        "dt_bias": ParamSpec((H,), ("heads",), "float32", init="zeros"),
        "A_log": ParamSpec((H,), ("heads",), "float32", init="ones"),
        "D": ParamSpec((H,), ("heads",), "float32", init="ones"),
        "conv_x": ParamSpec((cw, d_in), (None, "ffn"), cfg.dtype, scale=0.5),
        "conv_B": ParamSpec((cw, N), (None, None), cfg.dtype, scale=0.5),
        "conv_C": ParamSpec((cw, N), (None, None), cfg.dtype, scale=0.5),
        "norm": ParamSpec((d_in,), ("ffn",), "float32", init="zeros"),
        "out": ParamSpec((d_in, d), ("ffn", "embed"), cfg.dtype),
    }
    if cfg.ssm_conv_bias:
        # std 0.3 at any width (a 1-D spec's fan-in is its length)
        for name, n in (("conv_x_b", d_in), ("conv_B_b", N), ("conv_C_b", N)):
            p[name] = ParamSpec((n,), (None,), cfg.dtype, scale=0.3 * math.sqrt(n))
    return p


def ssd_chunked_ref(
    x: torch.Tensor,  # (B, T, H, P)
    dt: torch.Tensor,  # (B, T, H)  (post-softplus, >0)
    A: torch.Tensor,  # (H,)       (negative)
    Bm: torch.Tensor,  # (B, T, N)
    Cm: torch.Tensor,  # (B, T, N)
    chunk: int = 128,
    init_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD; returns (y (B,T,H,P), final_state (B,H,P,N)).  The
    reference's function: :func:`ssd_scan_plain` on its (B, H, T, P)
    layout, with the reference's chunk assertion."""
    T = x.shape[1]
    chunk = min(chunk, T)
    assert T % chunk == 0
    xb, a = _scan_inputs(x, dt, A)
    y, final_state = ssd_scan_plain(xb, a, Bm, Cm, chunk=chunk, init_state=init_state)
    return y.transpose(1, 2), final_state


def _scan_inputs(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor):
    """xb = x * dt and a = dt * A, as (B, H, T, P) and (B, H, T) views of
    (B, T, H, ...) storage."""
    xb = upcast(xh * dt[..., None])
    a = upcast(dt * A[None, None, :])
    return xb.transpose(1, 2), a.transpose(1, 2)


def _in_proj(params: dict, x: torch.Tensor):
    z = x @ params["in_z"]
    xs = x @ params["in_x"]
    Bm = x @ params["in_B"]
    Cm = x @ params["in_C"]
    dt = F.softplus(upcast(x @ params["in_dt"]) + params["dt_bias"])  # (B,T,H)
    return z, xs, Bm, Cm, dt


def _conv(params: dict, name: str, x: torch.Tensor, state: torch.Tensor | None = None):
    """The causal conv ``params[name]`` over x, plus its bias where the
    block has one (``ssm_conv_bias``); returns (y, new conv state)."""
    y, new_state = _causal_conv1d(x, params[name], state)
    bias = params.get(name + "_b")
    return (y if bias is None else y + bias), new_state


def _out_proj(params: dict, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    y = y * F.silu(z)  # gated
    y = rmsnorm(y, params["norm"], cfg.norm_eps)
    return y @ params["out"]


def ssd_block(params: dict, x: torch.Tensor, cfg: ModelConfig, chunk: int = 128, *, return_state: bool = False):
    """Full mamba2 block: (B,T,D) -> (B,T,D) [, final state dict]."""
    B_, T, D = x.shape
    d_in, H, P, N = _dims(cfg)
    assert T % min(chunk, T) == 0, f"T={T} is not a multiple of the chunk {min(chunk, T)}"
    z, xs, Bm, Cm, dt = _in_proj(params, x)

    xs, cx = _conv(params, "conv_x", xs)
    Bm, cb = _conv(params, "conv_B", Bm)
    Cm, cc = _conv(params, "conv_C", Cm)
    xs = F.silu(xs)
    Bm = F.silu(Bm)
    Cm = F.silu(Cm)

    A = -torch.exp(params["A_log"])  # (H,) negative
    xh = xs.reshape(B_, T, H, P)
    y, final_state = ssd_scan(*_scan_inputs(xh, dt, A), Bm, Cm)
    y = y.transpose(1, 2) + upcast(xh) * params["D"][None, None, :, None]
    y = y.reshape(B_, T, d_in).to(x.dtype)
    y = _out_proj(params, y, z, cfg)
    if return_state:
        return y, {"h": final_state, "conv_x": cx, "conv_B": cb, "conv_C": cc}
    return y


def ssd_state_init(cfg: ModelConfig, batch: int, device=None) -> dict:
    d_in, H, P, N = _dims(cfg)
    cw = cfg.ssm_conv
    dt = torch_dtype(cfg.dtype)
    return {
        "h": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, cw - 1, d_in), dtype=dt, device=device),
        "conv_B": torch.zeros((batch, cw - 1, N), dtype=dt, device=device),
        "conv_C": torch.zeros((batch, cw - 1, N), dtype=dt, device=device),
    }


def ssd_decode_step(
    params: dict,
    x: torch.Tensor,  # (B, 1, D)
    state: dict,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, dict]:
    """One token: (y (B, 1, D), new state dict).  The new state's tensors
    are fresh; ``state`` is only read."""
    B_ = x.shape[0]
    d_in, H, P, N = _dims(cfg)
    z, xs, Bm, Cm, dt = _in_proj(params, x)

    xs, cx = _conv(params, "conv_x", xs, state["conv_x"])
    Bm, cb = _conv(params, "conv_B", Bm, state["conv_B"])
    Cm, cc = _conv(params, "conv_C", Cm, state["conv_C"])
    xs = upcast(F.silu(xs)[:, 0].reshape(B_, H, P))
    Bm = upcast(F.silu(Bm)[:, 0])  # (B,N)
    Cm = upcast(F.silu(Cm)[:, 0])
    dt = dt[:, 0]  # (B,H)

    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A[None, :])  # (B,H)
    h = state["h"] * decay[..., None, None] + torch.einsum("bhp,bn->bhpn", xs * dt[..., None], Bm)
    y = torch.einsum("bhpn,bn->bhp", h, Cm) + xs * params["D"][None, :, None]
    y = y.reshape(B_, 1, d_in).to(x.dtype)
    y = _out_proj(params, y, z, cfg)
    return y, {"h": h, "conv_x": cx, "conv_B": cb, "conv_C": cc}
