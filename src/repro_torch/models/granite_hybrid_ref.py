"""granite-4.0-h (``granitemoehybrid``) forward pass in plain float32 torch.

The plain reference the port's granite-4.0-h model is held to: every
operation written out as the published modelling code computes it, with
no kernel, no cache, no batching across requests and no chunked scan.  It
imports nothing but ``torch``; a byte-identical copy serves the
benchmark's check.

The equations (``config`` holds the published ``config.json`` keys):

* ``h = embed[tokens] * embedding_multiplier``.
* Each layer of ``layer_types``, ``"mamba"`` or ``"attention"``:
  ``h = h + residual_multiplier * mixer(rmsnorm1(h))``, then
  ``h = h + residual_multiplier * (moe(rmsnorm2(h)) + shared(rmsnorm2(h)))``.
* Attention: causal GQA without position embedding, softmax scale
  ``attention_multiplier``, no bias.
* MoE: router logits ``x @ W_r``; the top ``num_experts_per_tok`` logits
  and a softmax over them are the gates; each expert and the shared
  expert is ``(silu(x @ W_g) * (x @ W_u)) @ W_o``, the shared one with
  weight 1.
* Mamba-2: the in-projection to z, x, B, C and dt; a causal depthwise
  conv over (x, B, C) with bias, then silu; ``dt = softplus(dt +
  dt_bias)``, ``A = -exp(A_log)``; the recurrence ``s_t = exp(dt_t A)
  s_{t-1} + dt_t x_t B_t^T``, ``y_t = s_t C_t + D x_t`` (one group);
  ``out_proj(rmsnorm(y * silu(z)))``.
* Head: ``rmsnorm(h) @ embed^T / logits_scaling`` (tied embeddings).

Departures from the published model, none of them in the function:

* Parameters come in the port's layout: (in, out) matrices, the
  in-projection as five matrices (``in_z``, ``in_x``, ``in_B``, ``in_C``,
  ``in_dt``), the conv as three (k, channels) weights with biases
  ``conv_*_b``, each expert's input projection as ``wi_gate`` and
  ``wi_up``, the shared expert under ``moe.shared``.
* Every rmsnorm weight is stored as its offset from 1: the norm
  multiplies by ``1 + w``.
* The router's top k is ``torch.topk``, whose order among exactly equal
  logits is its own.

Weights may be given in any dtype and on any device: each layer's are
upcast to float32 as the layer runs and freed after it, so a bf16 model
is held once.  TF32 is off inside :func:`forward`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["forward"]


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + w)


def _swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo"]


def _attention(p: dict, x: torch.Tensor, config: dict) -> torch.Tensor:
    B, T, _ = x.shape
    nh, nkv = config["num_attention_heads"], config["num_key_value_heads"]
    hd = config["hidden_size"] // nh
    q = (x @ p["wq"]).reshape(B, T, nh, hd).transpose(1, 2)
    k = (x @ p["wk"]).reshape(B, T, nkv, hd).transpose(1, 2).repeat_interleave(nh // nkv, dim=1)
    v = (x @ p["wv"]).reshape(B, T, nkv, hd).transpose(1, 2).repeat_interleave(nh // nkv, dim=1)
    s = (q @ k.transpose(-1, -2)) * config["attention_multiplier"]
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.softmax(s, dim=-1) @ v
    return o.transpose(1, 2).reshape(B, T, nh * hd) @ p["wo"]


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over time: x (B, T, C), w (k, C), b (C,)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i : i + x.shape[1]] * w[i] for i in range(k)) + b


def _mamba(p: dict, x: torch.Tensor, config: dict) -> torch.Tensor:
    B, T, _ = x.shape
    H, P = config["mamba_n_heads"], config["mamba_d_head"]
    z = x @ p["in_z"]
    xs = F.silu(_conv(x @ p["in_x"], p["conv_x"], p["conv_x_b"]))
    Bm = F.silu(_conv(x @ p["in_B"], p["conv_B"], p["conv_B_b"]))
    Cm = F.silu(_conv(x @ p["in_C"], p["conv_C"], p["conv_C_b"]))
    dt = F.softplus(x @ p["in_dt"] + p["dt_bias"])  # (B, T, H)
    A = -torch.exp(p["A_log"])  # (H,)
    xh = xs.reshape(B, T, H, P)
    s = x.new_zeros(B, H, P, Bm.shape[-1])
    ys = []
    for t in range(T):
        decay = torch.exp(dt[:, t] * A)[:, :, None, None]
        s = decay * s + (dt[:, t, :, None] * xh[:, t])[..., None] * Bm[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", s, Cm[:, t]))
    y = torch.stack(ys, dim=1) + p["D"][:, None] * xh
    y = y.reshape(B, T, H * P) * F.silu(z)
    return _rmsnorm(y, p["norm"], config["rms_norm_eps"]) @ p["out"]


def _moe(p: dict, x: torch.Tensor, config: dict) -> torch.Tensor:
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    logits = x @ p["router"]
    top, idx = torch.topk(logits, config["num_experts_per_tok"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    y = torch.zeros_like(x)
    for e in range(p["wi_gate"].shape[0]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            expert = {"wi_gate": p["wi_gate"][e], "wi_up": p["wi_up"][e], "wo": p["wo"][e]}
            y.index_add_(0, tok, gates[tok, slot, None] * _swiglu(expert, x[tok]))
    return (y + _swiglu(p["shared"], x)).reshape(shape)


def forward(config: dict, top: dict, layers: list[dict], tokens: torch.Tensor, last: int | None = None) -> torch.Tensor:
    """Logits (B, T', V) in float32 of ``tokens`` (B, T): every position,
    or the ``last`` ones.

    ``top`` holds ``embed`` (V, D) and ``final_norm``; ``layers[i]``, for
    ``config["layer_types"][i]``, holds ``norm1``, ``norm2``, ``moe`` and
    ``ssd`` (a mamba layer) or ``attn`` (an attention layer)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        eps, m = config["rms_norm_eps"], config["residual_multiplier"]
        embed = top["embed"].float()
        h = embed[tokens] * config["embedding_multiplier"]
        for kind, lp in zip(config["layer_types"], layers, strict=True):
            p = _f32(lp)
            x = _rmsnorm(h, p["norm1"], eps)
            h = h + m * (_mamba(p["ssd"], x, config) if kind == "mamba" else _attention(p["attn"], x, config))
            h = h + m * _moe(p["moe"], _rmsnorm(h, p["norm2"], eps), config)
            del p
        if last is not None:
            h = h[:, -last:]
        return _rmsnorm(h, top["final_norm"].float(), eps) @ embed.t() / config["logits_scaling"]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
