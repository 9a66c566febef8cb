"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427) — in PyTorch.

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
a_t = exp(-c * softplus(Lambda) * r_t),  r_t/i_t = sigmoid(gates)

The port of ``repro.models.rglru``.

* :func:`rglru_block` runs its recurrence through
  :func:`repro_torch.kernels.rglru_scan` (the hand-written CUDA kernel on
  the card, the sequential recurrence on the CPU), where the reference
  calls its associative-scan oracle :func:`rglru_scan_ref`; the two
  compute the same recurrence from ``h_0 = 0``.
* :func:`rglru_decode_step` is the O(1) state update in plain torch, as
  the reference's is plain jnp.
* :func:`_causal_conv1d` is also the mamba2 SSD block's conv
  (``repro_torch.models.ssd``), kept in the module where the reference
  keeps it.

As in the reference, the r/i gates are per-channel (diagonal) rather than
Griffin's block-diagonal projections.  The port does not shard: the
reference's ``constrain`` calls are dropped.
"""

from __future__ import annotations

import torch

from repro_torch._device import upcast
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec, gelu, torch_dtype

__all__ = ["rglru_params", "rglru_block", "rglru_decode_step", "rglru_scan_ref", "rglru_state_init"]

_C = 8.0  # Griffin's fixed scaling constant


def rglru_params(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    cw = cfg.conv1d_width
    return {
        "wx": ParamSpec((d, w), ("embed", "ffn"), cfg.dtype),  # recurrent branch in
        "wg": ParamSpec((d, w), ("embed", "ffn"), cfg.dtype),  # gate branch in
        "wo": ParamSpec((w, d), ("ffn", "embed"), cfg.dtype),
        "conv_w": ParamSpec((cw, w), (None, "ffn"), cfg.dtype, scale=0.5),
        "lam": ParamSpec((w,), ("ffn",), "float32", init="ones", scale=1.0),
        "gate_a_w": ParamSpec((w,), ("ffn",), "float32", init="zeros"),
        "gate_a_b": ParamSpec((w,), ("ffn",), "float32", init="zeros"),
        "gate_i_w": ParamSpec((w,), ("ffn",), "float32", init="zeros"),
        "gate_i_b": ParamSpec((w,), ("ffn",), "float32", init="zeros"),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv over T.  x (B,T,W), w (CW,W).
    Returns (y, new_state) where state carries the last CW-1 inputs."""
    cw = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, T+cw-1, W)
    y = sum(xp[:, i : i + x.shape[1], :] * w[i][None, None, :] for i in range(cw))
    new_state = xp[:, -(cw - 1) :, :] if cw > 1 else torch.zeros_like(pad)
    return y, new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (torch's
    ``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(params: dict, xr: torch.Tensor):
    """a_t and the scaled input b_t of the recurrence, both float32."""
    x32 = upcast(xr)
    r = torch.sigmoid(x32 * params["gate_a_w"] + params["gate_a_b"])
    i = torch.sigmoid(x32 * params["gate_i_w"] + params["gate_i_b"])
    log_a = -_C * _softplus(params["lam"]) * r  # (B,T,W) <= 0
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    b = mult * (i * x32)
    return a, b


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 (T), float32.  ``h0`` is folded
    into ``b[:, 0]`` as the reference folds it; the recurrence is then the
    kernel's plain version."""
    if h0 is not None:
        b = b.clone()
        b[:, 0] = b[:, 0] + a[:, 0] * h0
    return rglru_scan_plain(a, b)


def rglru_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *, return_state: bool = False):
    """Full Griffin recurrent block: (B,T,D) -> (B,T,D) [, final state]."""
    xr = x @ params["wx"]
    xg = x @ params["wg"]
    xr, conv_state = _causal_conv1d(xr, params["conv_w"])
    a, b = _gates(params, xr)
    h = rglru_scan(a, b)
    # the reference's order of casts: gelu in x's dtype, the product in fp32
    y = (upcast(gelu(xg)) * h).to(x.dtype)
    y = y @ params["wo"]
    if return_state:
        return y, {"h": h[:, -1], "conv": conv_state}
    return y


def rglru_decode_step(
    params: dict,
    x: torch.Tensor,  # (B, 1, D)
    state: dict,  # {"h": (B,W), "conv": (B,CW-1,W)}
    cfg: ModelConfig,
) -> tuple[torch.Tensor, dict]:
    """One token: (y (B, 1, D), new state dict).  The new state's tensors
    are fresh; ``state`` is only read."""
    xr = x @ params["wx"]
    xg = x @ params["wg"]
    xr, conv_state = _causal_conv1d(xr, params["conv_w"], state["conv"])
    a, b = _gates(params, xr)  # (B,1,W)
    h = a[:, 0] * state["h"] + b[:, 0]  # (B,W)
    y = (upcast(gelu(xg[:, 0])) * h).to(x.dtype)
    y = (y @ params["wo"])[:, None, :]
    return y, {"h": h, "conv": conv_state}


def rglru_state_init(cfg: ModelConfig, batch: int, device=None) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=torch_dtype(cfg.dtype), device=device),
    }
